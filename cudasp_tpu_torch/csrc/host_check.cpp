// Host build of secp256k1.cuh (g++, no CUDA): the kernel's own arithmetic,
// callable through ctypes so the CPU tests can check it before any card
// does. Same row layout as the kernel: planes of B rows, word i of row r
// at plane[i * B + r].
//
// Built with -DSP_STATIC_TU='"<path>"' it also compiles a per-key static
// translation unit written by ops/kernels.py (its KeyLadder) and exports
// sp_scan_rows_static.
#include "secp256k1.cuh"

namespace {

template <class Ladder>
void host_rows(const Ladder& lad, const uint32_t* tw, const uint32_t* oh,
               const uint32_t* ol, const uint32_t* ovm,
               const uint32_t* spend, const uint32_t* labels, int nlabels,
               const uint32_t* comb, int B, int M, int wire_xy, int hi,
               int8_t* flags) {
    // the kernel's per-row steps (scan.cuh), on the host
    uint32_t tab[sp::TAB_WORDS];
    for (int r = 0; r < B; r++) {
        uint32_t v = sp::row_ovm(oh + r, hi >= sp::HI_16 ? nullptr : ovm + r,
                                 B, M, hi);
        flags[r] = (int8_t)sp::scan_row(
            tw + r, B, wire_xy, oh + r, hi == sp::HI_EXACT ? ol + r : nullptr,
            M, hi, v, lad, spend, labels, nlabels, comb,
            sp::OddTable{tab, 1});
    }
}

}  // namespace

extern "C" {

void sp_fe_mul(const uint32_t* a, const uint32_t* b, uint32_t* out) {
    sp::fe r = sp::fe_mul(sp::fe_load(a, 1), sp::fe_load(b, 1));
    for (int i = 0; i < 8; i++) out[i] = r.v[i];
}

void sp_fe_sqr(const uint32_t* a, uint32_t* out) {
    sp::fe r = sp::fe_sqr(sp::fe_load(a, 1));
    for (int i = 0; i < 8; i++) out[i] = r.v[i];
}

void sp_fe_add(const uint32_t* a, const uint32_t* b, uint32_t* out) {
    sp::fe r = sp::fe_add(sp::fe_load(a, 1), sp::fe_load(b, 1));
    for (int i = 0; i < 8; i++) out[i] = r.v[i];
}

void sp_fe_sub(const uint32_t* a, const uint32_t* b, uint32_t* out) {
    sp::fe r = sp::fe_sub(sp::fe_load(a, 1), sp::fe_load(b, 1));
    for (int i = 0; i < 8; i++) out[i] = r.v[i];
}

void sp_fe_inv(const uint32_t* a, uint32_t* out) {
    sp::fe r = sp::fe_inv(sp::fe_load(a, 1));
    for (int i = 0; i < 8; i++) out[i] = r.v[i];
}

void sp_fe_sqrt(const uint32_t* a, uint32_t* out) {
    sp::fe r = sp::fe_sqrt(sp::fe_load(a, 1));
    for (int i = 0; i < 8; i++) out[i] = r.v[i];
}

void sp_fe_canon(const uint32_t* a, uint32_t* out) {
    sp::fe r = sp::fe_canon(sp::fe_load(a, 1));
    for (int i = 0; i < 8; i++) out[i] = r.v[i];
}

// The carry chains' host forms, in place on r (see secp256k1.cuh); the
// tests hold each to Python integers and to an emulation of its PTX.
// r: 2n + 1 words
void sp_mad_pairs(int n, uint32_t* r, const uint32_t* x, uint32_t y) {
    switch (n) {
        case 1: sp::mad_pairs<1>(r, x, y); break;
        case 2: sp::mad_pairs<2>(r, x, y); break;
        case 3: sp::mad_pairs<3>(r, x, y); break;
        default: sp::mad_pairs<4>(r, x, y); break;
    }
}

uint32_t sp_add8(uint32_t* r, const uint32_t* b) { return sp::add8(r, b); }

uint32_t sp_add8c(uint32_t* r, const uint32_t* b, uint32_t cin) {
    return sp::add8c(r, b, cin);
}

uint32_t sp_sub8(uint32_t* r, const uint32_t* b) { return sp::sub8(r, b); }

uint32_t sp_add3_8(uint32_t* r, uint32_t f0, uint32_t f1, uint32_t f2) {
    return sp::add3_8(r, f0, f1, f2);
}

uint32_t sp_sub2_8(uint32_t* r, uint32_t f0, uint32_t f1) {
    return sp::sub2_8(r, f0, f1);
}

void sp_add2_3(uint32_t* r, uint32_t f0, uint32_t f1) {
    sp::add2_3(r, f0, f1);
}

void sp_sub2_3(uint32_t* r, uint32_t f0, uint32_t f1) {
    sp::sub2_3(r, f0, f1);
}

// ladder: 0 = fixed, digits (2, 34); 1 = wnaf, digits (2, 54). M: the
// real output count; hi: 0 exact, 1 hi32, 2 hi16, 3 hi8.
void sp_scan_rows(const uint32_t* tw, const uint32_t* oh, const uint32_t* ol,
                  const uint32_t* ovm, int ladder, const int32_t* digits,
                  const uint32_t* spend, const uint32_t* labels, int nlabels,
                  const uint32_t* comb, int B, int M, int wire_xy, int hi,
                  int8_t* flags) {
    if (ladder == 1)
        host_rows(sp::wnaf_ladder(digits), tw, oh, ol, ovm, spend, labels,
                  nlabels, comb, B, M, wire_xy, hi, flags);
    else
        host_rows(sp::fixed_ladder(digits), tw, oh, ol, ovm, spend, labels,
                  nlabels, comb, B, M, wire_xy, hi, flags);
}

}  // extern "C"

#ifdef SP_STATIC_TU
#include SP_STATIC_TU

extern "C" void sp_scan_rows_static(
    const uint32_t* tw, const uint32_t* oh, const uint32_t* ol,
    const uint32_t* ovm, const uint32_t* spend, const uint32_t* labels,
    int nlabels, const uint32_t* comb, int B, int M, int wire_xy, int hi,
    int8_t* flags) {
    host_rows(KeyLadder(), tw, oh, ol, ovm, spend, labels, nlabels, comb, B,
              M, wire_xy, hi, flags);
}
#endif
