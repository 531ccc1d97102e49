// The fused BIP-352 scan kernel for Hopper (sm_90a): raw tweak words to
// match flags, one thread per row.
//
// Replaces the TPU kernel _scan_pallas_call -> _scan_kernel / _scan_block
// (cudasp_tpu/ops/kernels.py:377-828) with ladder="fixed" on the x and xy
// wires, including its block skip and its packed-flag epilogue. Per row:
// decompress (x wire), affine odd multiples (2m+1)P with one inversion
// (Montgomery's trick over the row's own z's), the GLV ladder over the
// shared odd-digit schedule, to-affine + tagged SHA-256, the fixed-base
// comb read directly from the 512 KB table in global memory (L2-resident;
// the TPU did a one-hot matmul here), + spend / + labels, and the
// upper-64 semi-join (secp256k1.cuh).
//
// What bounds it on this card: 32-bit integer multiply-add issue. A row
// costs about 3,500 field products (the ladder's 124 doublings and 64
// adds, four exponentiations of ~270 products each, the comb's 32 adds),
// each 64 32x32->64-bit multiply-adds plus the fold. The memory traffic is
// ~60 bytes a row. This first version is one thread per row with no
// shared-memory staging: the per-row table lives in local memory, and
// fe_mul is a call, not inlined, to keep the build short. Making it fast
// is later work.
#include <cuda_runtime.h>

#include "secp256k1.cuh"

namespace {

const int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
scan_kernel(const uint32_t* __restrict__ tw, const uint32_t* __restrict__ oh,
            const uint32_t* __restrict__ ol, const uint32_t* __restrict__ ovm,
            const sp::Sched sched, const uint32_t* __restrict__ spend,
            const uint32_t* __restrict__ labels, int nlabels,
            const uint32_t* __restrict__ comb,
            const int32_t* __restrict__ blockmask, int block_rows, int B,
            int M, int wire_xy, int packed, void* flags) {
    int r = blockIdx.x * THREADS + threadIdx.x;
    int flag = 0;
    // block skip: rows of a dead tile write 0 and do no EC work
    if (r < B && (blockmask == nullptr || blockmask[r / block_rows] != 0)) {
        flag = sp::scan_row(tw + r, B, wire_xy, oh + r, ol + r, M, ovm[r],
                            sched, spend, labels, nlabels, comb);
    }
    if (packed) {
        // 32 flags per uint32, bit i = row 32w + i (B is a multiple of 32)
        unsigned bits = __ballot_sync(0xFFFFFFFFu, flag);
        if ((threadIdx.x & 31) == 0 && r < B)
            static_cast<uint32_t*>(flags)[r >> 5] = bits;
    } else if (r < B) {
        static_cast<int8_t*>(flags)[r] = (int8_t)flag;
    }
}

}  // namespace

// Plain C entry point for ctypes. digits: host pointer to the (2, 34)
// int32 schedule, passed to the kernel by value. blockmask may be null.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int cudasp_scan_launch(
    const uint32_t* tw, const uint32_t* oh, const uint32_t* ol,
    const uint32_t* ovm, const int32_t* digits, const uint32_t* spend,
    const uint32_t* labels, int nlabels, const uint32_t* comb,
    const int32_t* blockmask, int block_rows, int B, int M, int wire_xy,
    int packed, void* flags, void* stream) {
    sp::Sched s;
    for (int h = 0; h < 2; h++)
        for (int i = 0; i < sp::SCHED_COLS; i++)
            s.d[h][i] = (uint8_t)digits[h * sp::SCHED_COLS + i];
    int blocks = (B + THREADS - 1) / THREADS;
    if (blocks > 0)
        scan_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            tw, oh, ol, ovm, s, spend, labels, nlabels, comb, blockmask,
            block_rows, B, M, wire_xy, packed, flags);
    return (int)cudaGetLastError();
}
