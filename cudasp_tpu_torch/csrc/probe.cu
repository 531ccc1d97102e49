// The three probe kernels for Hopper (sm_90a), one thread per lane, with
// plain C entry points for ctypes. ops/probes.py builds this file into a
// library of its own at first use; the scan kernel's library is not
// touched. The per-lane bodies are in probe.cuh.
//
// Replace the Pallas kernels of the JAX package's tools:
//   alu_kernel    tools/alu_probe.py::_kernel (:26, call :47)
//   bench_kernel  tools/microbench.py::_bench_kernel (:27, call :50)
//   stage_kernel  tools/stage_profile.py::run_stage.make.kern (:53, call :66)
//
// What bounds them on this card: alu_kernel, the issue rate of the op it
// measures (it is the measurement of that peak); bench_kernel and
// stage_kernel on a field or curve body, 32-bit integer multiply-add
// issue, as the scan kernel (72 multiply-adds a field product, 44 a
// square). Each lane reads and writes 4-64 bytes a launch, so memory is
// never the bound.
// Design: a TPU kernel ran one VMEM tile on one core; here each lane is a
// thread, 128 a block, and the default width (262,144 lanes, 2,048
// blocks) fills all 132 SMs. `iters` is a runtime argument and the loop
// is rolled, so nvcc can neither fold nor unroll it, and each case is its
// own instantiation, picked by the launcher, so the timed loop carries no
// branch on the case.
#include <cuda_runtime.h>

#include "probe.cuh"

namespace sp {
namespace probe {

const int PROBE_THREADS = 128;

inline int blocks(int n) { return (n + PROBE_THREADS - 1) / PROBE_THREADS; }

// lane r: x[r] -> out[r]
template <class Op>
__global__ void __launch_bounds__(PROBE_THREADS)
alu_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
           int iters, int n) {
    int r = blockIdx.x * PROBE_THREADS + threadIdx.x;
    if (r < n) out[r] = alu_lane<Op>(x[r], iters);
}

// lane r: words i of x, y and out at [i * B + r]
template <class Body>
__global__ void __launch_bounds__(PROBE_THREADS)
bench_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
             uint32_t* __restrict__ out, int iters, int B) {
    int r = blockIdx.x * PROBE_THREADS + threadIdx.x;
    if (r >= B) return;
    fe o = bench_lane<Body>(fe_load(x + r, B), fe_load(y + r, B), iters);
    SP_UNROLL
    for (int i = 0; i < 8; i++) out[i * B + r] = o.v[i];
}

// the same layout; comb is the scan kernel's (32, 256, 2, 8) table. A
// stage that stages its bytes gets its thread's column of a shared
// (32, PROBE_THREADS) byte array; the others get a 1-byte dummy.
template <class Stage>
__global__ void __launch_bounds__(PROBE_THREADS)
stage_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
             const uint32_t* __restrict__ comb, uint32_t* __restrict__ out,
             int iters, int B) {
    __shared__ uint8_t staged[Stage::SMEM ? 32 * PROBE_THREADS : 1];
    int r = blockIdx.x * PROBE_THREADS + threadIdx.x;
    if (r >= B) return;
    fe o = stage_lane<Stage>(fe_load(x + r, B), fe_load(y + r, B), comb,
                             staged + (Stage::SMEM ? threadIdx.x : 0),
                             PROBE_THREADS, iters);
    SP_UNROLL
    for (int i = 0; i < 8; i++) out[i * B + r] = o.v[i];
}

// One field op a lane, out = op(a, b) as the op leaves it (below 2^256,
// not canonical): chip_smoke.py's field-edges phase holds the carry
// chains' PTX to Python integers with it. Op: 0 fe_mul, 1 fe_sqr, 2
// fe_add, 3 fe_sub. Not a probe of the JAX package's tools.
template <int Op>
__global__ void __launch_bounds__(PROBE_THREADS)
field_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
             uint32_t* __restrict__ out, int B) {
    int r = blockIdx.x * PROBE_THREADS + threadIdx.x;
    if (r >= B) return;
    fe a = fe_load(x + r, B), b = fe_load(y + r, B);
    fe o = Op == 0 ? fe_mul(a, b) : Op == 1 ? fe_sqr(a)
         : Op == 2 ? fe_add(a, b) : fe_sub(a, b);
    SP_UNROLL
    for (int i = 0; i < 8; i++) out[i * B + r] = o.v[i];
}

}  // namespace probe
}  // namespace sp

using namespace sp::probe;

// Each entry point launches one case on `stream` and returns the
// cudaError_t of the launch (0 = launched); an unknown case or a bad size
// returns cudaErrorInvalidValue and launches nothing.

// op: index into ops/probes.py ALU_OPS; x, out: n int32 lanes
extern "C" int cudasp_probe_alu(int op, const int32_t* x, int32_t* out,
                                int iters, int n, void* stream) {
    if (n <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
    bool ok = visit_alu(op, [&](auto o) {
        alu_kernel<decltype(o)><<<blocks(n), PROBE_THREADS, 0,
                                  (cudaStream_t)stream>>>(x, out, iters, n);
    });
    return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// body: index into BENCH_CASES; x, y, out: (8, B) uint32 planes
extern "C" int cudasp_probe_bench(int body, const uint32_t* x,
                                  const uint32_t* y, uint32_t* out,
                                  int iters, int B, void* stream) {
    if (B <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
    bool ok = visit_bench(body, [&](auto o) {
        bench_kernel<decltype(o)><<<blocks(B), PROBE_THREADS, 0,
                                    (cudaStream_t)stream>>>(x, y, out,
                                                            iters, B);
    });
    return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// stage: index into STAGES; x, y, out: (8, B) uint32 planes; comb: the
// (32, 256, 2, 8) comb table (read by the comb stages only)
extern "C" int cudasp_probe_stage(int stage, const uint32_t* x,
                                  const uint32_t* y, const uint32_t* comb,
                                  uint32_t* out, int iters, int B,
                                  void* stream) {
    if (B <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
    bool ok = visit_stage(stage, [&](auto o) {
        stage_kernel<decltype(o)><<<blocks(B), PROBE_THREADS, 0,
                                    (cudaStream_t)stream>>>(x, y, comb, out,
                                                            iters, B);
    });
    return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// op: index into ops/probes.py FIELD_OPS; x, y, out: (8, B) uint32 planes
extern "C" int cudasp_probe_field(int op, const uint32_t* x,
                                  const uint32_t* y, uint32_t* out, int B,
                                  void* stream) {
    if (B <= 0 || op < 0 || op > 3) return (int)cudaErrorInvalidValue;
    auto kern = op == 0 ? field_kernel<0> : op == 1 ? field_kernel<1>
              : op == 2 ? field_kernel<2> : field_kernel<3>;
    kern<<<blocks(B), PROBE_THREADS, 0, (cudaStream_t)stream>>>(x, y, out,
                                                               B);
    return (int)cudaGetLastError();
}
