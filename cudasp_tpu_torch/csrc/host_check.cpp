// Host build of secp256k1.cuh (g++, no CUDA): the kernel's own arithmetic,
// callable through ctypes so the CPU tests can check it before any card
// does. Same row layout as scan.cu: planes of B rows, word i of row r at
// plane[i * B + r].
#include "secp256k1.cuh"

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

void sp_scan_rows(const uint32_t* tw, const uint32_t* oh, const uint32_t* ol,
                  const uint32_t* ovm, const int32_t* digits,
                  const uint32_t* spend, const uint32_t* labels, int nlabels,
                  const uint32_t* comb, int B, int M, int wire_xy,
                  int8_t* flags) {
    sp::Sched s;
    for (int h = 0; h < 2; h++)
        for (int i = 0; i < sp::SCHED_COLS; i++)
            s.d[h][i] = (uint8_t)digits[h * sp::SCHED_COLS + i];
    for (int r = 0; r < B; r++)
        flags[r] = (int8_t)sp::scan_row(tw + r, B, wire_xy, oh + r, ol + r,
                                        M, ovm[r], s, spend, labels, nlabels,
                                        comb);
}

}  // extern "C"
