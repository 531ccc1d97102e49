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
    for (int r = 0; r < B; r++) {
        uint32_t v = sp::row_ovm(oh + r, hi >= sp::HI_16 ? nullptr : ovm + r,
                                 B, M, hi);
        flags[r] = (int8_t)sp::scan_row(
            tw + r, B, wire_xy, oh + r, hi == sp::HI_EXACT ? ol + r : nullptr,
            M, hi, v, lad, spend, labels, nlabels, comb);
    }
}

}  // namespace

extern "C" {

void sp_fe_mul(const uint32_t* a, const uint32_t* b, uint32_t* out) {
    sp::fe r = sp::fe_mul(sp::fe_load(a, 1), sp::fe_load(b, 1));
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
