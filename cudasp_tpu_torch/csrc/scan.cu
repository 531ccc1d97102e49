// The scan kernel (scan.cuh) with the two ladders that read the scan
// key's schedule as data: "fixed" (odd-digit windows, 64 adds) and "wnaf"
// (merged-GLV width-5 wNAF, ~43 adds). One library holds both.
#include "scan.cuh"

// Plain C entry point for ctypes. ladder: 0 = fixed, digits the (2, 34)
// int32 odd schedule; 1 = wnaf, digits the (2, 54) int32 wNAF steps.
// digits is a host pointer; the kernel gets the schedule by value as a
// launch parameter. blockmask may be null. M is the real output count;
// hi the match planes' wire: 0 exact, 1 hi32, 2 hi16, 3 hi8 (ol, and on
// hi16 / hi8 ovm, are then never read). Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int cudasp_scan_launch(
    const uint32_t* tw, const uint32_t* oh, const uint32_t* ol,
    const uint32_t* ovm, int ladder, const int32_t* digits,
    const uint32_t* spend, const uint32_t* labels, int nlabels,
    const uint32_t* comb, const int32_t* blockmask, int block_rows, int B,
    int M, int wire_xy, int hi, int packed, void* flags, void* stream) {
    if (ladder == 1)
        return sp::launch_scan(sp::wnaf_ladder(digits), tw, oh, ol, ovm,
                               spend, labels, nlabels, comb, blockmask,
                               block_rows, B, M, wire_xy, hi, packed, flags,
                               stream);
    if (ladder != 0) return (int)cudaErrorInvalidValue;
    return sp::launch_scan(sp::fixed_ladder(digits), tw, oh, ol, ovm, spend,
                           labels, nlabels, comb, blockmask, block_rows, B,
                           M, wire_xy, hi, packed, flags, stream);
}
