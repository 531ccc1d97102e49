// The bodies of the three probe kernels (probe.cu): an ALU throughput
// loop, a field / curve op micro-benchmark and the scan kernel's stages
// one at a time. Each body is SP_HD over the scan kernel's own types and
// functions (secp256k1.cuh), so g++ builds it for the host check
// (probe_host.cpp) and nvcc for the card, and a stage times exactly the
// code that scan_row() runs.
//
// Counterparts of the Pallas kernels of the JAX package's tools:
//   alu_lane    tools/alu_probe.py::_kernel (:26): 8 independent int32
//               streams, each s = op(s, x) & 0x1FFF per iteration, summed
//   bench body  tools/microbench.py::_bench_kernel (:27): (a, b) =
//               body(a, b) per iteration; out = a + b
//   stage body  tools/stage_profile.py::run_stage.make.kern (:53): a =
//               stage(a, b) per iteration; out = a
// The raw int32 bodies work on the 8 words of an fe as 8 independent
// int32 values (the JAX bodies' (20, B) planes become (8, B)); the field
// and curve bodies on the field element. Every body is a type, chosen on
// the host: the timed loop carries no per-iteration branch on the case.
#pragma once

#include "secp256k1.cuh"

namespace sp {
namespace probe {

const int32_t MASK13 = 0x1FFF;
const int NSTREAMS = 8;

// a * b + c, rounded once to float32: one FFMA on the card; on the host
// the sum is exact in float64 (the probes' operands are integers below
// 2^14, so a * b + c < 2^29) and rounds once on the conversion
SP_HD SP_INLINE float fma_once(float a, float b, float c) {
#ifdef __CUDA_ARCH__
    return __fmaf_rn(a, b, c);
#else
    return (float)((double)a * (double)b + (double)c);
#endif
}

// Hides b from the optimiser on the card, so an operand that is the same
// every iteration counts as new in each, and work on it alone (serial's
// inversion of b) cannot be hoisted out of the timed loop. It changes no
// value and emits no instruction; the host build times nothing.
SP_HD SP_INLINE void opaque(fe& b) {
#ifdef __CUDA_ARCH__
    SP_UNROLL
    for (int i = 0; i < 8; i++) asm volatile("" : "+r"(b.v[i]));
#else
    (void)b;
#endif
}

// ---------------------------------------------------------------------------
// ALU ops (tools/alu_probe.py:79-86)
// ---------------------------------------------------------------------------

struct AluMul {
    SP_HD SP_INLINE int32_t operator()(int32_t a, int32_t b) const {
        return a * b;
    }
};
struct AluAdd {
    SP_HD SP_INLINE int32_t operator()(int32_t a, int32_t b) const {
        return a + b;
    }
};
struct AluMulAdd {
    SP_HD SP_INLINE int32_t operator()(int32_t a, int32_t b) const {
        return a * b + b;
    }
};
struct AluShift {
    SP_HD SP_INLINE int32_t operator()(int32_t a, int32_t) const {
        return a >> 3;
    }
};
struct AluFma {
    SP_HD SP_INLINE int32_t operator()(int32_t a, int32_t b) const {
        return (int32_t)fma_once((float)a, (float)b, (float)b);
    }
};

template <class Op>
SP_HD SP_INLINE int32_t alu_lane(int32_t x, int iters) {
    int32_t s[NSTREAMS];
    SP_UNROLL
    for (int i = 0; i < NSTREAMS; i++) s[i] = x + i;
    SP_ROLLED
    for (int it = 0; it < iters; it++) {
        SP_UNROLL
        for (int i = 0; i < NSTREAMS; i++) s[i] = Op()(s[i], x) & MASK13;
    }
    int32_t acc = s[0];
    SP_UNROLL
    for (int i = 1; i < NSTREAMS; i++) acc += s[i];
    return acc;
}

// the ops in the order of ops/probes.py ALU_OPS
template <class Visit>
inline bool visit_alu(int op, Visit&& v) {
    switch (op) {
        case 0: v(AluMul()); return true;
        case 1: v(AluAdd()); return true;
        case 2: v(AluMulAdd()); return true;
        case 3: v(AluShift()); return true;
        case 4: v(AluFma()); return true;
    }
    return false;
}

// ---------------------------------------------------------------------------
// Micro-benchmark bodies (tools/microbench.py:85-142)
// ---------------------------------------------------------------------------

// the raw bodies' per-word ops
struct RawMul {
    SP_HD SP_INLINE int32_t operator()(int32_t a, int32_t b) const {
        return (a * b) & MASK13;
    }
};
struct RawAdd {
    SP_HD SP_INLINE int32_t operator()(int32_t a, int32_t b) const {
        return (a + b) & MASK13;
    }
};
struct RawShr {
    SP_HD SP_INLINE int32_t operator()(int32_t a, int32_t b) const {
        return (a >> 3) + b;
    }
};
struct RawFmul {
    SP_HD SP_INLINE int32_t operator()(int32_t a, int32_t b) const {
        return (int32_t)((float)a * (float)b) & MASK13;
    }
};

// 4 independent chains a, a+1, a+2, a+3 (the JAX tool's ilp4)
template <class Op>
struct Ilp4 {
    static const bool RAW = true;
    SP_HD SP_INLINE int32_t lane(int32_t a, int32_t b) const {
        Op op;
        return (op(a, b) + op(a + 1, b) + op(a + 2, b) + op(a + 3, b))
               & MASK13;
    }
};

struct RawMadd {
    static const bool RAW = true;
    SP_HD SP_INLINE int32_t lane(int32_t a, int32_t b) const {
        return (a * b + b) & MASK13;
    }
};
struct RawFma {
    static const bool RAW = true;
    SP_HD SP_INLINE int32_t lane(int32_t a, int32_t b) const {
        return (int32_t)fma_once((float)a, (float)b, (float)b) & MASK13;
    }
};

struct FieldAdd {
    static const bool RAW = false;
    SP_HD SP_INLINE void step(fe& a, fe& b) const { a = fe_add(a, b); }
};
// the scan kernel's own fe_mul and fe_sqr, inlined into the timed loop:
// the product's 64 partial products as two chains of 64-bit multiply-adds
// a row, the square's 28 cross products once plus 8 squares, each reduced
// by two chains of the same shape (secp256k1.cuh)
struct FieldMul {
    static const bool RAW = false;
    SP_HD SP_INLINE void step(fe& a, fe& b) const { a = fe_mul(a, b); }
};
struct FieldSqr {
    static const bool RAW = false;
    SP_HD SP_INLINE void step(fe& a, fe&) const { a = fe_sqr(a); }
};
// the JAX body's K._dbl(a, b, 1) -> (x, y + z); pt_dbl is its formula
struct EcDbl {
    static const bool RAW = false;
    SP_HD SP_INLINE void step(fe& a, fe& b) const {
        jac p;
        p.x = a; p.y = b; p.z = fe_one();
        jac r = pt_dbl(p);
        a = r.x;
        b = fe_add(r.y, r.z);
    }
};
// K._madd_core(a, b, 1, b, a) -> (x, y + z); pt_madd is its formula
struct EcMadd {
    static const bool RAW = false;
    SP_HD SP_INLINE void step(fe& a, fe& b) const {
        jac p;
        p.x = a; p.y = b; p.z = fe_one();
        jac r = pt_madd(p, b, a);
        a = r.x;
        b = fe_add(r.y, r.z);
    }
};
struct FieldInv {
    static const bool RAW = false;
    SP_HD SP_INLINE void step(fe& a, fe&) const { a = fe_inv(a); }
};

// one iteration of a body: raw bodies map a's words and keep b
template <class Body>
SP_HD SP_INLINE void bench_step(fe& a, fe& b) {
    if constexpr (Body::RAW) {
        fe r;
        SP_UNROLL
        for (int i = 0; i < 8; i++)
            r.v[i] = (uint32_t)Body().lane((int32_t)a.v[i], (int32_t)b.v[i]);
        a = r;
    } else {
        Body().step(a, b);
    }
}

// out = a + b: word-wise int32 for the raw bodies, the canonical field
// sum for the others
template <class Body>
SP_HD SP_INLINE fe bench_lane(fe a, fe b, int iters) {
    SP_ROLLED
    for (int it = 0; it < iters; it++) {
        opaque(b);
        bench_step<Body>(a, b);
    }
    if constexpr (Body::RAW) {
        fe r;
        SP_UNROLL
        for (int i = 0; i < 8; i++) r.v[i] = a.v[i] + b.v[i];
        return r;
    } else {
        return fe_canon(fe_add(a, b));
    }
}

// the bodies in the order of ops/probes.py BENCH_CASES
template <class Visit>
inline bool visit_bench(int body, Visit&& v) {
    switch (body) {
        case 0: v(Ilp4<RawMul>()); return true;
        case 1: v(Ilp4<RawAdd>()); return true;
        case 2: v(Ilp4<RawShr>()); return true;
        case 3: v(Ilp4<RawFmul>()); return true;
        case 4: v(RawMadd()); return true;
        case 5: v(RawFma()); return true;
        case 6: v(FieldAdd()); return true;
        case 7: v(FieldMul()); return true;
        case 8: v(FieldSqr()); return true;
        case 9: v(EcDbl()); return true;
        case 10: v(EcMadd()); return true;
        case 11: v(FieldInv()); return true;
    }
    return false;
}

// ---------------------------------------------------------------------------
// Scan stages (tools/stage_profile.py:85-236), as scan_row() runs them
// ---------------------------------------------------------------------------

// the n < 32 bits of a canonical value from bit `pos` up
SP_HD SP_INLINE uint32_t fe_bits(const fe& a, int pos, int n) {
    int k = pos >> 5, s = pos & 31;
    uint32_t v = a.v[k] >> s;
    if (s + n > 32 && k + 1 < 8) v |= a.v[k + 1] << (32 - s);
    return v & ((1u << n) - 1u);
}

// y = +-sqrt(x^3 + 7), the odd root (scan_row's decompress, parity 1)
struct Decompress {
    static const bool SMEM = false;
    SP_HD SP_INLINE fe operator()(fe a, fe, const uint32_t*, uint8_t*,
                                  int) const {
        fe seven = fe_zero();
        seven.v[0] = 7;
        fe y0 = fe_sqrt(fe_add(fe_mul(fe_sqr(a), a), seven));
        return (fe_canon(y0).v[0] & 1u) ? y0 : fe_neg(y0);
    }
};

// one ladder window: 4 doublings and 2 mixed adds from (a, b, 1)
struct Window {
    static const bool SMEM = false;
    SP_HD SP_INLINE fe operator()(fe a, fe b, const uint32_t*, uint8_t*,
                                  int) const {
        jac p;
        p.x = a; p.y = b; p.z = fe_one();
        SP_ROLLED
        for (int k = 0; k < 4; k++) p = pt_dbl(p);
        p = pt_madd(p, a, b);
        p = pt_madd(p, b, a);
        return fe_add(p.x, fe_add(p.y, p.z));
    }
};

// the odd-multiple table (build_table: co-Z chain + one inversion):
// beta x + the affine x of 3P..15P
struct Table {
    static const bool SMEM = false;
    SP_HD SP_INLINE fe operator()(fe a, fe b, const uint32_t*, uint8_t*,
                                  int) const {
        uint32_t buf[TAB_WORDS];
        OddTable t{buf, 1};
        build_table(a, b, t);
        fe acc = t.get(TAB_BX);
        SP_ROLLED
        for (int m = 1; m < 8; m++) acc = fe_add(acc, t.get(TAB_X + m));
        return acc;
    }
};

// (a, b) as Jacobian (x, z = b): to affine, serialize, tagged hash; the
// first 20 hash bytes (most significant first) as the value
// sum byte_i 2^(13 i) < 2^255 (the JAX body's 13-bit limbs)
struct Serial {
    static const bool SMEM = false;
    SP_HD SP_INLINE fe operator()(fe a, fe b, const uint32_t*, uint8_t*,
                                  int) const {
        fe zi = fe_inv(b);
        fe zi2 = fe_sqr(zi);
        fe ax = fe_canon(fe_mul(a, zi2));
        uint32_t par = fe_canon(fe_mul(b, fe_mul(zi, zi2))).v[0] & 1u;
        uint32_t hw[8];
        tagged_hash(ax, par, hw);
        fe r = fe_zero();
        SP_UNROLL
        for (int i = 0; i < 20; i++) {
            uint32_t byte = (hw[i >> 2] >> (8 * (3 - (i & 3)))) & 0xFFu;
            int k = (13 * i) >> 5, s = (13 * i) & 31;
            r.v[k] |= byte << s;
            if (s + 8 > 32) r.v[k + 1] |= byte >> (32 - s);
        }
        return r;
    }
};

// 32 comb windows from (a, b, 1): window i adds entry [i][byte_i] with
// byte_i = bits 13 (i mod 20) .. +8 of canonical a, all 32 entries (entry
// 0 too, with no skip). The bytes are fixed up front, as the scan kernel
// fixes its hash bytes: in registers (packed 4 a word, as comb_mul reads
// them), or, with SMEM, staged through shared memory and read back a
// window at a time (the counterpart of the JAX tool's VMEM-scratch body).
template <bool Smem>
struct Comb {
    static const bool SMEM = Smem;
    SP_HD SP_INLINE fe operator()(fe a, fe b, const uint32_t* comb,
                                  uint8_t* bytes, int stride) const {
        fe ac = fe_canon(a);
        uint32_t bw[8];
        SP_UNROLL
        for (int w = 0; w < 8; w++) bw[w] = 0;
        SP_UNROLL
        for (int i = 0; i < 32; i++) {
            uint32_t byte = fe_bits(ac, 13 * (i % 20), 8);
            if constexpr (Smem)
                bytes[i * stride] = (uint8_t)byte;
            else
                bw[i >> 2] |= byte << (8 * (3 - (i & 3)));
        }
        jac p;
        p.x = a; p.y = b; p.z = fe_one();
        SP_ROLLED
        for (int i = 0; i < 32; i++) {
            uint32_t byte;
            if constexpr (Smem)
                byte = bytes[i * stride];
            else
                byte = (bw[i >> 2] >> (8 * (3 - (i & 3)))) & 0xFFu;
            const uint32_t* e = comb + ((size_t)i * 256 + byte) * 16;
            p = pt_madd(p, fe_load(e, 1), fe_load(e + 8, 1));
        }
        return fe_add(p.x, fe_add(p.y, p.z));
    }
};

// two candidates (P + (b, a), then + (a, b)), each to affine x with its
// own inversion (candidate_hits' per-candidate inversion; zero inverts
// to zero), and the upper-64 compare of x's top words against each other:
// a on a hit, else b
struct Match2 {
    static const bool SMEM = false;
    SP_HD SP_INLINE fe operator()(fe a, fe b, const uint32_t*, uint8_t*,
                                  int) const {
        jac p;
        p.x = a; p.y = b; p.z = fe_one();
        jac c[2];
        c[0] = pt_madd(p, b, a);
        c[1] = pt_madd(c[0], a, b);
        bool hit = false;
        SP_ROLLED
        for (int j = 0; j < 2; j++) {
            fe zi = fe_inv(c[j].z);
            fe x = fe_canon(fe_mul(c[j].x, fe_sqr(zi)));
            hit = hit | ((x.v[7] == x.v[6]) & (x.v[5] == x.v[4]));
        }
        return hit ? a : b;
    }
};

template <class Stage>
SP_HD SP_INLINE fe stage_lane(fe a, fe b, const uint32_t* comb,
                              uint8_t* bytes, int stride, int iters) {
    SP_ROLLED
    for (int it = 0; it < iters; it++) {
        opaque(b);
        a = Stage()(a, b, comb, bytes, stride);
    }
    return fe_canon(a);
}

// the stages in the order of ops/probes.py STAGES
template <class Visit>
inline bool visit_stage(int stage, Visit&& v) {
    switch (stage) {
        case 0: v(Decompress()); return true;
        case 1: v(Window()); return true;
        case 2: v(Table()); return true;
        case 3: v(Serial()); return true;
        case 4: v(Comb<false>()); return true;
        case 5: v(Comb<true>()); return true;
        case 6: v(Match2()); return true;
    }
    return false;
}

}  // namespace probe
}  // namespace sp
