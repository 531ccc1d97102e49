// The fused BIP-352 scan kernel for Hopper (sm_90a) as a template on the
// scan key's ladder: raw tweak words to match flags, one thread per row.
// scan.cu instantiates it for the fixed and wnaf ladders; ops/kernels.py
// generates one translation unit per scan key for the static ladder.
//
// Replaces the TPU kernel _scan_pallas_call -> _scan_kernel / _scan_block
// (cudasp_tpu/ops/kernels.py:377-828) on the x and xy wires, including
// its block skip and its packed-flag epilogue, with ladder="fixed"
// (:571-606), "wnaf" (:514-542) or "static" (:543-570), and on the hi32,
// hi16 and hi8 prefilter wires (hi_only, :428-450 and :683-727; the
// launch argument `hi`). Per row:
// decompress (x wire), affine odd multiples (2m+1)P with one inversion
// (Montgomery's trick over the row's own z's), the GLV ladder, to-affine
// + tagged SHA-256, the fixed-base comb read directly from the 512 KB
// table in global memory (L2-resident; the TPU did a one-hot matmul
// here), + spend / + labels, and the upper-64 semi-join (secp256k1.cuh).
//
// What bounds it on this card: 32-bit integer multiply-add issue. A row
// costs about 3,100 field products with the fixed ladder (124 doublings
// and 64 adds, four exponentiations of ~270 products each, the comb's 32
// adds), about 220 fewer with the wNAF ladders (~43 adds); each product
// is 64 32x32->64-bit multiply-adds plus the fold. The memory traffic is
// ~60 bytes a row (36-48 on a cut wire). The wire is a runtime argument,
// not a template parameter: it is uniform across a launch, changes only
// the validity unfold and the final compare, and keeps each library at
// one kernel per ladder (and the per-key build time where it was). This first version is one thread per row with no
// shared-memory staging: the per-row table lives in local memory, and
// fe_mul is a call, not inlined, to keep the build short. The ladder's
// schedule is the same for every row, so its branches are warp-uniform.
// Making it fast is later work.
#pragma once

#include "secp256k1.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace sp {

const int SCAN_THREADS = 128;

template <class Ladder>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const uint32_t* __restrict__ tw, const uint32_t* __restrict__ oh,
            const uint32_t* __restrict__ ol, const uint32_t* __restrict__ ovm,
            const Ladder lad, const uint32_t* __restrict__ spend,
            const uint32_t* __restrict__ labels, int nlabels,
            const uint32_t* __restrict__ comb,
            const int32_t* __restrict__ blockmask, int block_rows, int B,
            int M, int wire_xy, int hi, int packed, void* flags) {
    int r = blockIdx.x * SCAN_THREADS + threadIdx.x;
    int flag = 0;
    // block skip: rows of a dead tile write 0 and do no EC work
    if (r < B && (blockmask == nullptr || blockmask[r / block_rows] != 0)) {
        // on a cut wire ol (and on hi16 / hi8 ovm) is a dummy: the row's
        // validity word is unfolded from oh before the padding-row test
        // and the parity read, and neither dummy is dereferenced
        uint32_t v = row_ovm(oh + r, hi >= HI_16 ? nullptr : ovm + r, B, M,
                             hi);
        flag = scan_row(tw + r, B, wire_xy, oh + r,
                        hi == HI_EXACT ? ol + r : nullptr, M, hi, v, lad,
                        spend, labels, nlabels, comb);
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

// Launches one batch on `stream`; returns the cudaError_t of the launch
// (0 = launched). blockmask may be null. M is the real output count of a
// row; hi the match planes' wire (HI_EXACT .. HI_8).
template <class Ladder>
int launch_scan(const Ladder& lad, const uint32_t* tw, const uint32_t* oh,
                const uint32_t* ol, const uint32_t* ovm,
                const uint32_t* spend, const uint32_t* labels, int nlabels,
                const uint32_t* comb, const int32_t* blockmask,
                int block_rows, int B, int M, int wire_xy, int hi,
                int packed, void* flags, void* stream) {
    if (hi < HI_EXACT || hi > HI_8 || (hi != HI_EXACT && wire_xy))
        return (int)cudaErrorInvalidValue;
    int blocks = (B + SCAN_THREADS - 1) / SCAN_THREADS;
    if (blocks > 0)
        scan_kernel<Ladder><<<blocks, SCAN_THREADS, 0,
                              (cudaStream_t)stream>>>(
            tw, oh, ol, ovm, lad, spend, labels, nlabels, comb, blockmask,
            block_rows, B, M, wire_xy, hi, packed, flags);
    return (int)cudaGetLastError();
}

}  // namespace sp
#endif  // __CUDACC__
