// Host build of probe.cuh (g++, no CUDA): the probe kernels' per-lane
// bodies looped over the lanes, callable through ctypes, so the CPU tests
// hold the card's own probe code against the plain version before any
// card does. Same layouts and case indices as probe.cu; each returns 0,
// or 1 for an unknown case.
#include "probe.cuh"

using namespace sp;
using namespace sp::probe;

extern "C" {

int sp_probe_alu(int op, const int32_t* x, int32_t* out, int iters, int n) {
    return visit_alu(op, [&](auto o) {
        for (int r = 0; r < n; r++) out[r] = alu_lane<decltype(o)>(x[r], iters);
    }) ? 0 : 1;
}

int sp_probe_bench(int body, const uint32_t* x, const uint32_t* y,
                   uint32_t* out, int iters, int B) {
    return visit_bench(body, [&](auto o) {
        for (int r = 0; r < B; r++) {
            fe v = bench_lane<decltype(o)>(fe_load(x + r, B),
                                           fe_load(y + r, B), iters);
            for (int i = 0; i < 8; i++) out[i * B + r] = v.v[i];
        }
    }) ? 0 : 1;
}

int sp_probe_stage(int stage, const uint32_t* x, const uint32_t* y,
                   const uint32_t* comb, uint32_t* out, int iters, int B) {
    return visit_stage(stage, [&](auto o) {
        uint8_t bytes[32];
        for (int r = 0; r < B; r++) {
            fe v = stage_lane<decltype(o)>(fe_load(x + r, B),
                                           fe_load(y + r, B), comb, bytes,
                                           1, iters);
            for (int i = 0; i < 8; i++) out[i * B + r] = v.v[i];
        }
    }) ? 0 : 1;
}

}  // extern "C"
