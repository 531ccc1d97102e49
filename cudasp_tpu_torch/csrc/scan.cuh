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
// costs about 3,100 field products and squares with the fixed ladder (124
// doublings and 64 adds, four exponentiations of ~270 products each, the
// comb's 32 adds), about 220 fewer with the wNAF ladders (~43 adds); a
// product is 64 32x32-bit multiply-adds plus the fold, a square 36. The
// memory traffic is ~60 bytes a row (36-48 on a cut wire). The wire is a
// runtime argument, not a template parameter: it is uniform across a
// launch, changes only the validity unfold and the final compare, and
// keeps each library at one kernel per ladder (and the per-key build time
// where it was).
//
// What the design does about it: one thread per row. The field product
// and square (secp256k1.cuh) are chains of PTX multiply-adds with carry
// (mad.lo.cc / madc.hi.cc), which ptxas turns into 64-bit multiply-adds
// that carry through a predicate (IMAD.WIDE.U32.X): the product as an
// even/odd split whose chains always write the same aligned register
// pairs, the square with its 28 cross products once, both in registers
// and reduced by two more chains of the same shape. They are inlined into
// the point formulas, and the formulas into the fixed and wnaf ladders and
// the comb. The per-key ladder's steps, a row's one-off doubling and adds
// and the exponentiations (fe_inv, fe_sqrt: addition chains run as data)
// are calls, and SHA-256 runs its rounds 16 at a time, which keeps nvcc's
// time in bounds (PERF.md). The row's odd-multiple table (768 B) lives in
// dynamic shared memory, a column per thread, so a pick at a runtime index
// reads the thread's own bank: 6-7% faster than local memory through L1
// on the fixed and wnaf ladders. SCAN_THREADS and the table's place are
// the fastest setting of a sweep on the card that keeps a per-key unit
// free of spills (PERF.md).
// The ladder's schedule is the same for every row, so its branches are
// warp-uniform.
#pragma once

#include "secp256k1.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace sp {

const int SCAN_THREADS = 128;
// the block's odd-multiple tables in dynamic shared memory, a column a
// thread (96 KB: 2 blocks an SM)
const int SCAN_SMEM_BYTES = TAB_WORDS * 4 * SCAN_THREADS;

template <class Ladder>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const uint32_t* __restrict__ tw, const uint32_t* __restrict__ oh,
            const uint32_t* __restrict__ ol, const uint32_t* __restrict__ ovm,
            const Ladder lad, const uint32_t* __restrict__ spend,
            const uint32_t* __restrict__ labels, int nlabels,
            const uint32_t* __restrict__ comb,
            const int32_t* __restrict__ blockmask, int block_rows, int B,
            int M, int wire_xy, int hi, int packed, void* flags) {
    extern __shared__ uint32_t smem_table[];
    const OddTable tab{smem_table + threadIdx.x, SCAN_THREADS};
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
                        spend, labels, nlabels, comb, tab);
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
    // above 48 KB a block's dynamic shared memory must be asked for
    int rc = (int)cudaFuncSetAttribute(
        scan_kernel<Ladder>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SCAN_SMEM_BYTES);
    if (rc != 0) return rc;
    if (blocks > 0)
        scan_kernel<Ladder><<<blocks, SCAN_THREADS, SCAN_SMEM_BYTES,
                              (cudaStream_t)stream>>>(
            tw, oh, ol, ovm, lad, spend, labels, nlabels, comb, blockmask,
            block_rows, B, M, wire_xy, hi, packed, flags);
    return (int)cudaGetLastError();
}

}  // namespace sp
#endif  // __CUDACC__
