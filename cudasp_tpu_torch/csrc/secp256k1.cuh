// secp256k1 field, point and SHA-256 code for the BIP-352 scan, plus the
// per-row function scan_row(). Shared by the CUDA kernel (scan.cu) and a
// host build (host_check.cpp, compiled with g++ by the tests), so every
// function here is C++ behind SP_HD. Inline PTX appears only inside the
// carry chains (mad_pairs .. sub2_3), each of which has a plain C++
// form for the host beside it; there are no intrinsics.
//
// Field elements are 8 little-endian uint32 words; products are 32x32->64
// bit and reduce with 2^256 == 2^32 + 977 (mod p). Values stay below 2^256
// but need not be below p; fe_canon() gives the unique representative.
//
// scan_row() takes the scan key's ladder as a functor: FixedLadder and
// WnafLadder read the key's schedule as data; a per-key KeyLadder, which
// ops/kernels.py generates, has it compiled in through ladder_static().
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
// the host copies of these functions are never called from nvcc's output
// (the host build is host_check.cpp under g++), so their reads of the
// __constant__ tables are moot
#pragma nv_diag_suppress 20091
#define SP_HD __host__ __device__
#define SP_INLINE __forceinline__
#define SP_NOINLINE __noinline__
#define SP_CONST __constant__
#else
#define SP_HD
#define SP_INLINE inline
#define SP_NOINLINE __attribute__((noinline))
#define SP_CONST static const
#endif

#if defined(__CUDACC__) || defined(__clang__)
#define SP_PRAGMA(x) _Pragma(#x)
#else
#define SP_PRAGMA(x)
#endif
// keep a loop rolled: the ladder, comb and exponentiation loops run their
// bodies 22..88 times, and unrolling them multiplies ptxas's work
#define SP_ROLLED SP_PRAGMA(unroll 1)
#define SP_UNROLL SP_PRAGMA(unroll)

namespace sp {

struct fe {
    uint32_t v[8];
};

static const int ODD_WINDOWS = 32;
static const int SCHED_COLS = ODD_WINDOWS + 2;
static const int WNAF_STEPS = 54;

// The scan key's odd-digit ladder schedule (ops/scalar.py glv_odd_sched),
// one row per GLV half: cols 0..31 = idx | sign << 3, col 32 = correction
// flag, col 33 = correction y plane. Shared by every row; the kernel gets
// it by value as a launch parameter.
struct Sched {
    uint8_t d[2][SCHED_COLS];
};

// The scan key's merged-GLV width-5 wNAF steps (ops/scalar.py
// glv_wnaf_steps): step i doubles nd[i] times, then adds the table entry
// that code[i] names. Code bits 0-2: odd-multiple index; 3: negate y;
// 4: GLV half (beta x); 5: live add (0: no add). Passed by value too.
struct WSched {
    uint8_t nd[WNAF_STEPS];
    uint8_t code[WNAF_STEPS];
};

SP_CONST uint32_t P_WORDS[8] = {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu,
                                0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                0xFFFFFFFFu, 0xFFFFFFFFu};
// GLV endomorphism: lambda * (x, y) = (beta * x, y)
SP_CONST uint32_t BETA_WORDS[8] = {0x719501EEu, 0xC1396C28u, 0x12F58995u,
                                   0x9CF04975u, 0xAC3434E9u, 0x6E64479Eu,
                                   0x657C0710u, 0x7AE96A2Bu};
// SHA-256 state after SHA256(tag) || SHA256(tag), tag "BIP0352/SharedSecret"
SP_CONST uint32_t TAG_MIDSTATE[8] = {0x88831537u, 0x5127079Bu, 0x69C2137Bu,
                                     0xAB0303E6u, 0x98FA21FAu, 0x4A888523u,
                                     0xBD99DAABu, 0xF25E5E0Au};
SP_CONST uint32_t SHA_K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
    0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
    0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
    0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
    0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
    0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
    0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
    0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
    0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
    0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};

// ---------------------------------------------------------------------------
// Carry chains
//
// Every multi-word add, subtract and product of the field code is built
// from the chains below. On the card each chain is ONE asm block of PTX:
// add.cc / addc.cc / sub.cc / subc.cc ripple a carry or a borrow through
// the carry flag, and mad.lo.cc / madc.hi.cc add the low or high word of a
// 32 x 32-bit product into a word with it; the flag does not live from one
// asm statement to the next, so no chain is split across two. A carry
// leaves a chain as a register value. On the host (g++) the same chains
// run in uint64_t with the carry explicit, so the host build checks the
// algorithms written over them and the card checks the PTX. These are the
// header's only inline PTX.
// ---------------------------------------------------------------------------

// r[2k], r[2k + 1] = low and high word of x[k] * y, k < N (no carries)
template <int N>
SP_HD SP_INLINE void mul_pairs(uint32_t* r, const uint32_t* x, uint32_t y) {
    SP_UNROLL
    for (int k = 0; k < N; k++) {
        uint64_t p = (uint64_t)x[k] * y;
        r[2 * k] = (uint32_t)p;
        r[2 * k + 1] = (uint32_t)(p >> 32);
    }
}

// r[0 .. 2N) += sum_k x[k] * y * 2^(64k), N <= 4, one chain of
// alternating low and high product words, whose carry is added to r[2N]
// (the caller keeps r[2N] small: a fresh word or an earlier chain's carry)
template <int N>
SP_HD SP_INLINE void mad_pairs(uint32_t* r, const uint32_t* x, uint32_t y) {
#ifdef __CUDA_ARCH__
    static_assert(N >= 1 && N <= 4, "mad_pairs takes 1 to 4 pairs");
    if constexpr (N == 1) {
        asm volatile(
            "mad.lo.cc.u32  %0, %3, %4, %0;\n\t"
            "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
            "addc.u32 %2, %2, 0;"
            : "+r"(r[0]), "+r"(r[1]), "+r"(r[2])
            : "r"(x[0]), "r"(y));
    } else if constexpr (N == 2) {
        asm volatile(
            "mad.lo.cc.u32  %0, %5, %7, %0;\n\t"
            "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
            "madc.lo.cc.u32 %2, %6, %7, %2;\n\t"
            "madc.hi.cc.u32 %3, %6, %7, %3;\n\t"
            "addc.u32 %4, %4, 0;"
            : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4])
            : "r"(x[0]), "r"(x[1]), "r"(y));
    } else if constexpr (N == 3) {
        asm volatile(
            "mad.lo.cc.u32  %0, %7, %10, %0;\n\t"
            "madc.hi.cc.u32 %1, %7, %10, %1;\n\t"
            "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
            "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
            "madc.lo.cc.u32 %4, %9, %10, %4;\n\t"
            "madc.hi.cc.u32 %5, %9, %10, %5;\n\t"
            "addc.u32 %6, %6, 0;"
            : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
              "+r"(r[5]), "+r"(r[6])
            : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(y));
    } else {
        asm volatile(
            "mad.lo.cc.u32  %0, %9, %13, %0;\n\t"
            "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
            "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
            "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
            "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
            "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
            "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
            "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
            "addc.u32 %8, %8, 0;"
            : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
              "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(r[8])
            : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(y));
    }
#else
    uint64_t acc = 0;
    for (int k = 0; k < N; k++) {
        uint64_t p = (uint64_t)x[k] * y;
        acc += (uint64_t)r[2 * k] + (uint32_t)p;
        r[2 * k] = (uint32_t)acc;
        acc = (acc >> 32) + r[2 * k + 1] + (p >> 32);
        r[2 * k + 1] = (uint32_t)acc;
        acc >>= 32;
    }
    r[2 * N] += (uint32_t)acc;
#endif
}

// r[0 .. 8) += b[0 .. 8) + cin (cin 0 or 1); returns the carry out
SP_HD SP_INLINE uint32_t add8c(uint32_t* r, const uint32_t* b,
                               uint32_t cin) {
    uint32_t c = cin;
#ifdef __CUDA_ARCH__
    // cin + 0xFFFFFFFF sets the flag exactly when cin is 1
    asm volatile(
        "add.cc.u32 %8, %8, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32 %8, 0, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
          "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(c)
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
          "r"(b[6]), "r"(b[7]));
#else
    uint64_t acc = c;
    for (int i = 0; i < 8; i++) {
        acc += (uint64_t)r[i] + b[i];
        r[i] = (uint32_t)acc;
        acc >>= 32;
    }
    c = (uint32_t)acc;
#endif
    return c;
}

// r[0 .. 8) += b[0 .. 8); returns the carry out
SP_HD SP_INLINE uint32_t add8(uint32_t* r, const uint32_t* b) {
    uint32_t c;
#ifdef __CUDA_ARCH__
    asm volatile(
        "add.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32 %8, 0, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
          "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "=r"(c)
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
          "r"(b[6]), "r"(b[7]));
#else
    c = add8c(r, b, 0);
#endif
    return c;
}

// r[0 .. 8) -= b[0 .. 8) mod 2^256; returns the borrow (0 or 1)
SP_HD SP_INLINE uint32_t sub8(uint32_t* r, const uint32_t* b) {
    uint32_t m;
#ifdef __CUDA_ARCH__
    asm volatile(
        "sub.cc.u32 %0, %0, %9;\n\t"
        "subc.cc.u32 %1, %1, %10;\n\t"
        "subc.cc.u32 %2, %2, %11;\n\t"
        "subc.cc.u32 %3, %3, %12;\n\t"
        "subc.cc.u32 %4, %4, %13;\n\t"
        "subc.cc.u32 %5, %5, %14;\n\t"
        "subc.cc.u32 %6, %6, %15;\n\t"
        "subc.cc.u32 %7, %7, %16;\n\t"
        "subc.u32 %8, 0, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
          "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "=r"(m)
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
          "r"(b[6]), "r"(b[7]));
    m &= 1u;                             // subc 0 - 0 - borrow: all ones
#else
    uint64_t acc = 0;
    for (int i = 0; i < 8; i++) {
        acc = (uint64_t)r[i] - b[i] - acc;
        r[i] = (uint32_t)acc;
        acc = (acc >> 32) & 1u;
    }
    m = (uint32_t)acc;
#endif
    return m;
}

// r[0 .. 8) += f0 + f1 2^32 + f2 2^64; returns the carry out
SP_HD SP_INLINE uint32_t add3_8(uint32_t* r, uint32_t f0, uint32_t f1,
                                uint32_t f2) {
    uint32_t c;
#ifdef __CUDA_ARCH__
    asm volatile(
        "add.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, 0;\n\t"
        "addc.cc.u32 %4, %4, 0;\n\t"
        "addc.cc.u32 %5, %5, 0;\n\t"
        "addc.cc.u32 %6, %6, 0;\n\t"
        "addc.cc.u32 %7, %7, 0;\n\t"
        "addc.u32 %8, 0, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
          "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "=r"(c)
        : "r"(f0), "r"(f1), "r"(f2));
#else
    const uint32_t f[8] = {f0, f1, f2, 0, 0, 0, 0, 0};
    c = add8c(r, f, 0);
#endif
    return c;
}

// r[0 .. 8) -= f0 + f1 2^32 mod 2^256; returns the borrow (0 or 1)
SP_HD SP_INLINE uint32_t sub2_8(uint32_t* r, uint32_t f0, uint32_t f1) {
    uint32_t m;
#ifdef __CUDA_ARCH__
    asm volatile(
        "sub.cc.u32 %0, %0, %9;\n\t"
        "subc.cc.u32 %1, %1, %10;\n\t"
        "subc.cc.u32 %2, %2, 0;\n\t"
        "subc.cc.u32 %3, %3, 0;\n\t"
        "subc.cc.u32 %4, %4, 0;\n\t"
        "subc.cc.u32 %5, %5, 0;\n\t"
        "subc.cc.u32 %6, %6, 0;\n\t"
        "subc.cc.u32 %7, %7, 0;\n\t"
        "subc.u32 %8, 0, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
          "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "=r"(m)
        : "r"(f0), "r"(f1));
    m &= 1u;
#else
    const uint32_t f[8] = {f0, f1, 0, 0, 0, 0, 0, 0};
    m = sub8(r, f);
#endif
    return m;
}

// r[0 .. 3) += f0 + f1 2^32, for a caller that knows it cannot carry out
SP_HD SP_INLINE void add2_3(uint32_t* r, uint32_t f0, uint32_t f1) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "add.cc.u32 %0, %0, %3;\n\t"
        "addc.cc.u32 %1, %1, %4;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2])
        : "r"(f0), "r"(f1));
#else
    uint64_t acc = (uint64_t)r[0] + f0;
    r[0] = (uint32_t)acc;
    acc = (acc >> 32) + r[1] + f1;
    r[1] = (uint32_t)acc;
    r[2] += (uint32_t)(acc >> 32);
#endif
}

// r[0 .. 3) -= f0 + f1 2^32, for a caller that knows it cannot borrow out
SP_HD SP_INLINE void sub2_3(uint32_t* r, uint32_t f0, uint32_t f1) {
#ifdef __CUDA_ARCH__
    asm volatile(
        "sub.cc.u32 %0, %0, %3;\n\t"
        "subc.cc.u32 %1, %1, %4;\n\t"
        "subc.u32 %2, %2, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2])
        : "r"(f0), "r"(f1));
#else
    uint64_t acc = (uint64_t)r[0] - f0;
    r[0] = (uint32_t)acc;
    acc = (uint64_t)r[1] - f1 - ((acc >> 32) & 1u);
    r[1] = (uint32_t)acc;
    r[2] -= (uint32_t)((acc >> 32) & 1u);
#endif
}

// ---------------------------------------------------------------------------
// Field
// ---------------------------------------------------------------------------

SP_HD SP_INLINE fe fe_zero() {
    fe r;
    SP_UNROLL
    for (int i = 0; i < 8; i++) r.v[i] = 0;
    return r;
}

SP_HD SP_INLINE fe fe_one() {
    fe r = fe_zero();
    r.v[0] = 1;
    return r;
}

SP_HD SP_INLINE fe fe_load(const uint32_t* w, int stride) {
    fe r;
    SP_UNROLL
    for (int i = 0; i < 8; i++) r.v[i] = w[i * stride];
    return r;
}

// t (16 words, any value < 2^512) to a value < 2^256 that is t mod p.
// t_lo + t_hi (2^32 + 977) first, as two chains of the products' own
// shape: lo = t_lo + h_j 977 for even j (at words j, j + 1), and up =
// t_hi one word up + h_j 977 for odd j (word k + 1 at up[k]); their sum's
// part above 2^256 (top <= 2^32 + 977) is folded the same way, twice at
// most.
SP_HD SP_INLINE fe fe_reduce(const uint32_t* t) {
    const uint32_t* h = t + 8;
    const uint32_t hev[4] = {h[0], h[2], h[4], h[6]};
    const uint32_t hod[4] = {h[1], h[3], h[5], h[7]};
    uint32_t lo[9], up[9];
    SP_UNROLL
    for (int i = 0; i < 8; i++) {
        lo[i] = t[i];
        up[i] = h[i];
    }
    lo[8] = up[8] = 0;
    mad_pairs<4>(lo, hev, 977u);
    mad_pairs<4>(up, hod, 977u);
    uint32_t c9 = up[8] + add8(lo + 1, up);
    uint32_t c8 = lo[8];
    fe r;
    SP_UNROLL
    for (int i = 0; i < 8; i++) r.v[i] = lo[i];
    // top = c8 + c9 2^32; f = top (2^32 + 977) < 2^65 as three words: g =
    // top 977, then top one word up
    uint64_t g = (uint64_t)c8 * 977u + ((uint64_t)(c9 * 977u) << 32);
    uint64_t f1 = (g >> 32) + c8;
    uint32_t k = add3_8(r.v, (uint32_t)g, (uint32_t)f1,
                        (uint32_t)(f1 >> 32) + c9);
    // a carry leaves r < f < 2^65: one more 2^32 + 977 stays in 3 words
    add2_3(r.v, k * 977u, k);
    return r;
}

// a * b as 16 words by the even/odd split of GPU big-number libraries
// (the scheme of sppark's mont_t): row i's products a_j b_i land at words
// i + j (low) and i + j + 1 (high), so the pairs of even j form one chain
// from word i and those of odd j one from word i + 1, independent of each
// other. A chain that starts at an even word goes into ev_acc, one that
// starts at an odd word into od_acc (word k + 1 at od_acc[k]): every row
// then writes the same aligned (low, high) register pairs, which ptxas
// keeps as the 64-bit multiply-add's destination. a b = ev_acc +
// od_acc one word up. 64 32 x 32-bit products, all in registers.
SP_HD SP_INLINE fe fe_mul(const fe& a, const fe& b) {
    const uint32_t ev[4] = {a.v[0], a.v[2], a.v[4], a.v[6]};
    const uint32_t od[4] = {a.v[1], a.v[3], a.v[5], a.v[7]};
    uint32_t ev_acc[17], od_acc[16];
    SP_UNROLL
    for (int k = 8; k < 16; k++) ev_acc[k] = od_acc[k] = 0;
    ev_acc[16] = 0;
    mul_pairs<4>(ev_acc, ev, b.v[0]);
    mul_pairs<4>(od_acc, od, b.v[0]);
    SP_UNROLL
    for (int i = 1; i < 8; i++) {
        if (i & 1) {
            mad_pairs<4>(od_acc + i - 1, ev, b.v[i]);
            mad_pairs<4>(ev_acc + i + 1, od, b.v[i]);
        } else {
            mad_pairs<4>(ev_acc + i, ev, b.v[i]);
            mad_pairs<4>(od_acc + i, od, b.v[i]);
        }
    }
    // ev_acc[16] and od_acc[15] stay 0: a b < 2^512
    add8c(ev_acc + 9, od_acc + 8, add8(ev_acc + 1, od_acc));
    return fe_reduce(ev_acc);
}

// row I of a square's cross products: a_I a_j for j > I, those with j - I
// odd into xs from word 2I + 1 and those with j - I even into ys from word
// 2I + 2 (row 0 writes fresh words: plain products). Each row's carry
// lands on a word that is fresh or holds an earlier row's carry.
template <int I>
SP_HD SP_INLINE void sqr_row(uint32_t* xs, uint32_t* ys, const uint32_t* a) {
    const int NX = (8 - I) / 2, NY = (7 - I) / 2;
    uint32_t px[4] = {0, 0, 0, 0}, py[4] = {0, 0, 0, 0};
    SP_UNROLL
    for (int k = 0; k < NX; k++) px[k] = a[I + 1 + 2 * k];
    SP_UNROLL
    for (int k = 0; k < NY; k++) py[k] = a[I + 2 + 2 * k];
    if constexpr (I == 0) {
        mul_pairs<NX>(xs + 1, px, a[0]);
        mul_pairs<NY>(ys + 2, py, a[0]);
    } else {
        mad_pairs<NX>(xs + 2 * I + 1, px, a[I]);
        if constexpr (NY > 0) mad_pairs<NY>(ys + 2 * I + 2, py, a[I]);
    }
}

// a^2: the 28 cross products once (sqr_row), doubled by a shift whose
// outgoing bit carries into the next word, plus the 8 squares a_i^2 at
// word 2i; then the same reduction as fe_mul. Equal to fe_mul(a, a).
SP_HD SP_INLINE fe fe_sqr(const fe& a) {
    uint32_t xs[16], ys[16];
    SP_UNROLL
    for (int i = 0; i < 16; i++) xs[i] = ys[i] = 0;
    sqr_row<0>(xs, ys, a.v);
    sqr_row<1>(xs, ys, a.v);
    sqr_row<2>(xs, ys, a.v);
    sqr_row<3>(xs, ys, a.v);
    sqr_row<4>(xs, ys, a.v);
    sqr_row<5>(xs, ys, a.v);
    sqr_row<6>(xs, ys, a.v);
    // the cross products' sum is below 2^511: no carry out of either step
    add8c(xs + 8, ys + 8, add8(xs, ys));
    uint32_t t[16], d[16];
    t[0] = xs[0] << 1;
    SP_UNROLL
    for (int i = 1; i < 16; i++) t[i] = (xs[i] << 1) | (xs[i - 1] >> 31);
    SP_UNROLL
    for (int i = 0; i < 8; i++) mul_pairs<1>(d + 2 * i, a.v + i, a.v[i]);
    add8c(t + 8, d + 8, add8(t, d));
    return fe_reduce(t);
}

// a + b, both < 2^256: a carry out of 2^256 is 2^32 + 977, added back; a
// second carry leaves the sum below 2^33 + 977, so the third add stays in
// 3 words
SP_HD SP_INLINE fe fe_add(fe a, const fe& b) {
    uint32_t c = add8(a.v, b.v);
    uint32_t k = add3_8(a.v, c * 977u, c, 0);
    add2_3(a.v, k * 977u, k);
    return a;
}

// a - b: a borrow wrapped by 2^256 == 2^32 + 977 is taken back out; a
// second borrow leaves the difference at least 2^256 - 2^32 - 977, so the
// third subtraction stays in 3 words
SP_HD SP_INLINE fe fe_sub(fe a, const fe& b) {
    uint32_t bw = sub8(a.v, b.v);
    uint32_t k = sub2_8(a.v, bw * 977u, bw);
    sub2_3(a.v, k * 977u, k);
    return a;
}

SP_HD SP_INLINE fe fe_neg(fe a) { return fe_sub(fe_zero(), a); }

SP_HD SP_INLINE fe fe_canon(fe a) {
    fe d = a;
    return sub8(d.v, P_WORDS) ? a : d;   // borrow: a < p already
}

SP_HD SP_INLINE bool fe_is_zero(fe a) {
    fe c = fe_canon(a);
    uint32_t o = 0;
    SP_UNROLL
    for (int i = 0; i < 8; i++) o |= c.v[i];
    return o == 0;
}

SP_HD SP_INLINE fe fe_sqr_n(fe a, int n) {
    SP_ROLLED
    for (int i = 0; i < n; i++) a = fe_sqr(a);
    return a;
}

// libsecp256k1's addition chains for a^(p - 2) and a^((p + 1) / 4), as
// data: a step squares t n times, multiplies it by saved value m (none if
// m is POW_NONE) and then saves it in slot s (none if POW_NONE). Slot 0
// holds a; then x2, x3, x11 (later x88), x22, x44, where xk = a^(2^k - 1).
// One loop with one square and one product runs a chain, so a library
// holds two small copies of this code instead of the unrolled chains.
struct PowStep {
    uint8_t n, m, s;
};
enum { POW_NONE = 7, POW_SLOTS = 6, POW_INV = 0, POW_INV_STEPS = 15,
       POW_SQRT = 15, POW_SQRT_STEPS = 14 };
SP_CONST PowStep POW_STEPS[29] = {
    // a^(p - 2): x2, x3, x6, x9, x11, x22, x44, x88, x176, x220, x223,
    // then the tail
    {1, 0, 1}, {1, 0, 2}, {3, 2, POW_NONE}, {3, 2, POW_NONE}, {2, 1, 3},
    {11, 3, 4}, {22, 4, 5}, {44, 5, 3}, {88, 3, POW_NONE},
    {44, 5, POW_NONE}, {3, 2, POW_NONE}, {23, 4, POW_NONE},
    {5, 0, POW_NONE}, {3, 1, POW_NONE}, {2, 0, POW_NONE},
    // a^((p + 1) / 4): the same x223, then its own tail
    {1, 0, 1}, {1, 0, 2}, {3, 2, POW_NONE}, {3, 2, POW_NONE}, {2, 1, 3},
    {11, 3, 4}, {22, 4, 5}, {44, 5, 3}, {88, 3, POW_NONE},
    {44, 5, POW_NONE}, {3, 2, POW_NONE}, {23, 4, POW_NONE},
    {6, 1, POW_NONE}, {2, POW_NONE, POW_NONE}};

// the chain's steps first .. first + count - 1 from a; the saved values
// stay in registers (every slot is read and written at a constant index)
SP_HD SP_INLINE fe fe_pow(fe a, int first, int count) {
    fe slot[POW_SLOTS];
    SP_UNROLL
    for (int k = 0; k < POW_SLOTS; k++) slot[k] = a;
    fe t = a;
    SP_ROLLED
    for (int i = first; i < first + count; i++) {
        PowStep st = POW_STEPS[i];
        t = fe_sqr_n(t, st.n);
        if (st.m != POW_NONE) {
            fe m = slot[0];
            SP_UNROLL
            for (int k = 1; k < POW_SLOTS; k++)
                if (k == st.m) m = slot[k];
            t = fe_mul(t, m);
        }
        SP_UNROLL
        for (int k = 0; k < POW_SLOTS; k++)
            if (k == st.s) slot[k] = t;
    }
    return t;
}

// a^(p-2); zero inverts to zero
SP_HD SP_NOINLINE fe fe_inv(fe a) {
    return fe_pow(a, POW_INV, POW_INV_STEPS);
}

// a^((p+1)/4): the square root when a is a quadratic residue
SP_HD SP_NOINLINE fe fe_sqrt(fe a) {
    return fe_pow(a, POW_SQRT, POW_SQRT_STEPS);
}

// ---------------------------------------------------------------------------
// Points (Jacobian, a = 0); the formulas of the TPU kernel
// (cudasp_tpu/ops/kernels.py:232-296). Incomplete adds: P == +-Q is not
// special-cased; callers own infinity.
// ---------------------------------------------------------------------------

struct jac {
    fe x, y, z;
};

SP_HD SP_INLINE jac pt_dbl(const jac& p) {
    fe a = fe_sqr(p.x);
    fe b = fe_sqr(p.y);
    fe c = fe_sqr(b);
    fe d = fe_mul(p.x, b);
    d = fe_add(d, d);
    d = fe_add(d, d);                          // 4 x b
    fe e = fe_add(fe_add(a, a), a);            // 3 a
    jac r;
    r.x = fe_sub(fe_sqr(e), fe_add(d, d));
    fe c8 = fe_add(c, c);
    c8 = fe_add(c8, c8);
    c8 = fe_add(c8, c8);
    r.y = fe_sub(fe_mul(e, fe_sub(d, r.x)), c8);
    fe yz = fe_mul(p.y, p.z);
    r.z = fe_add(yz, yz);
    return r;
}

SP_HD SP_INLINE jac pt_madd(const jac& p, fe qx, fe qy) {
    fe z1z1 = fe_sqr(p.z);
    fe h = fe_sub(fe_mul(qx, z1z1), p.x);
    fe r = fe_sub(fe_mul(qy, fe_mul(p.z, z1z1)), p.y);
    fe hh = fe_sqr(h);
    fe h3 = fe_mul(h, hh);
    fe v = fe_mul(p.x, hh);
    jac o;
    o.x = fe_sub(fe_sub(fe_sqr(r), h3), fe_add(v, v));
    o.y = fe_sub(fe_mul(r, fe_sub(v, o.x)), fe_mul(p.y, h3));
    o.z = fe_mul(p.z, h);
    return o;
}

// Co-Z add-and-update: (x1, y1) and (x2, y2) share z. Returns P1 + P2 in
// (x3, y3) and P1 re-expressed at the new z in (x1, y1); z updated.
SP_HD SP_INLINE void pt_zaddu(fe& x1, fe& y1, fe x2, fe y2, fe& z, fe& x3,
                              fe& y3) {
    fe e = fe_sub(x1, x2);
    fe c = fe_sqr(e);
    fe w1 = fe_mul(x1, c);
    fe w2 = fe_mul(x2, c);
    fe dy = fe_sub(y1, y2);
    fe a1 = fe_mul(y1, fe_sub(w1, w2));
    x3 = fe_sub(fe_sub(fe_sqr(dy), w1), w2);
    y3 = fe_sub(fe_mul(dy, fe_sub(w1, x3)), a1);
    z = fe_mul(z, e);
    x1 = w1;
    y1 = a1;
}


// The formulas as calls, with the field code inlined inside them: the
// per-key ladder's ~170 steps and a row's one-off doubling and adds
// outside the ladders (build_table, scan_row) call these; the fixed and
// wnaf ladders and the comb, which run the rest of a row's ~220 doublings
// and adds, inline the formulas. Inlined at every site, they took a
// per-key unit to 20-22 s of nvcc, over its 20 s limit (PERF.md).
SP_HD SP_NOINLINE jac pt_dbl_call(jac p) { return pt_dbl(p); }
SP_HD SP_NOINLINE jac pt_madd_call(jac p, fe qx, fe qy) {
    return pt_madd(p, qx, qy);
}

// ---------------------------------------------------------------------------
// SHA-256: one compression from the tag midstate over 02/03 || x || 0^4
// ---------------------------------------------------------------------------

SP_HD SP_INLINE uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

// xc: canonical affine x (LE words); parity: y's low bit. h: 8 BE words.
// The 64 rounds run as 4 passes of 16 unrolled rounds over a 16-word
// message schedule, so the code is a quarter of the unrolled rounds'.
SP_HD SP_INLINE void tagged_hash(const fe& xc, uint32_t parity,
                                 uint32_t h[8]) {
    uint32_t xw[8];                      // big-endian words of x
    SP_UNROLL
    for (int i = 0; i < 8; i++) xw[i] = xc.v[7 - i];
    uint32_t w[16];
    w[0] = ((0x02u + parity) << 24) | (xw[0] >> 8);
    SP_UNROLL
    for (int i = 1; i < 8; i++) w[i] = (xw[i - 1] << 24) | (xw[i] >> 8);
    w[8] = (xw[7] & 0xFFu) << 24;
    w[9] = 0x00800000u;
    SP_UNROLL
    for (int i = 10; i < 15; i++) w[i] = 0;
    w[15] = (64 + 37) * 8;
    uint32_t a = TAG_MIDSTATE[0], b = TAG_MIDSTATE[1], c = TAG_MIDSTATE[2],
             d = TAG_MIDSTATE[3], e = TAG_MIDSTATE[4], f = TAG_MIDSTATE[5],
             g = TAG_MIDSTATE[6], hh = TAG_MIDSTATE[7];
    SP_ROLLED
    for (int t0 = 0; t0 < 64; t0 += 16) {
        SP_UNROLL
        for (int j = 0; j < 16; j++) {
            if (t0 > 0) {                // w[t] from w[t - 16 .. t - 2]
                uint32_t w15 = w[(j + 1) & 15], w2 = w[(j + 14) & 15];
                uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
                uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
                w[j] += s0 + w[(j + 9) & 15] + s1;
            }
            uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            uint32_t ch = (e & f) ^ (~e & g);
            uint32_t t1 = hh + s1 + ch + SHA_K[t0 + j] + w[j];
            uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + s0 + maj;
        }
    }
    h[0] = TAG_MIDSTATE[0] + a; h[1] = TAG_MIDSTATE[1] + b;
    h[2] = TAG_MIDSTATE[2] + c; h[3] = TAG_MIDSTATE[3] + d;
    h[4] = TAG_MIDSTATE[4] + e; h[5] = TAG_MIDSTATE[5] + f;
    h[6] = TAG_MIDSTATE[6] + g; h[7] = TAG_MIDSTATE[7] + hh;
}

// ---------------------------------------------------------------------------
// One row of the scan
// ---------------------------------------------------------------------------

// Affine odd multiples (2m+1) P, m = 0..7, and beta * x of each (the GLV
// half-2 table); y's sign is applied at pick time. OddTable is a view:
// entry e (x of (2m+1) P at TAB_X + m, beta x at TAB_BX + m, y at TAB_Y +
// m) keeps word i at w[(8 e + i) * stride], so the storage is a thread's
// own array (stride 1) or its column of a block's table in shared memory
// (stride: the block's threads), where a thread's reads fall on its own
// bank whatever entry it picks.
enum { TAB_X = 0, TAB_BX = 8, TAB_Y = 16, TAB_WORDS = 24 * 8 };

struct OddTable {
    uint32_t* w;
    int stride;
    SP_HD SP_INLINE fe get(int e) const {
        return fe_load(w + 8 * e * stride, stride);
    }
    SP_HD SP_INLINE void put(int e, const fe& a) const {
        SP_UNROLL
        for (int i = 0; i < 8; i++) w[(8 * e + i) * stride] = a.v[i];
    }
};

SP_HD SP_INLINE void build_table(fe px, fe py, const OddTable& t) {
    // Co-Z chain: 2P and P aligned at 2P's z, then each ZADDU emits
    // (2m+1) P and re-expresses 2P at the new z
    jac p0;
    p0.x = px; p0.y = py; p0.z = fe_one();
    jac d2 = pt_dbl_call(p0);
    fe zz = fe_sqr(d2.z);
    fe ox = fe_mul(px, zz);
    fe oy = fe_mul(py, fe_mul(zz, d2.z));
    fe dx = d2.x, dy = d2.y, z = d2.z;
    fe cx[7], cy[7], cz[7];
    SP_ROLLED
    for (int m = 0; m < 7; m++) {
        fe nx, ny;
        pt_zaddu(dx, dy, ox, oy, z, nx, ny);
        cx[m] = nx; cy[m] = ny; cz[m] = z;
        ox = nx; oy = ny;
    }
    // Montgomery's trick over the row's 7 z's: one inversion; zero -> zero
    fe pre[7];
    bool nz[7];
    fe run = fe_one();
    SP_ROLLED
    for (int m = 0; m < 7; m++) {
        nz[m] = fe_is_zero(cz[m]);
        fe s = nz[m] ? fe_one() : cz[m];
        pre[m] = run;                       // product of the z's before m
        run = fe_mul(run, s);
    }
    run = fe_inv(run);
    fe beta = fe_load(BETA_WORDS, 1);
    t.put(TAB_X, px);
    t.put(TAB_Y, py);
    t.put(TAB_BX, fe_mul(beta, px));
    SP_ROLLED
    for (int m = 6; m >= 0; m--) {
        fe s = nz[m] ? fe_one() : cz[m];
        fe zi = fe_mul(run, pre[m]);
        run = fe_mul(run, s);
        if (nz[m]) zi = fe_zero();
        fe zi2 = fe_sqr(zi);
        fe ax = fe_mul(cx[m], zi2);
        t.put(TAB_X + m + 1, ax);
        t.put(TAB_Y + m + 1, fe_mul(cy[m], fe_mul(zi, zi2)));
        t.put(TAB_BX + m + 1, fe_mul(beta, ax));
    }
}

SP_HD SP_INLINE void pick(const OddTable& t, int h, uint32_t code, fe& x,
                          fe& y) {
    int idx = code & 7;
    x = t.get((h ? TAB_BX : TAB_X) + idx);
    y = t.get(TAB_Y + idx);
    if ((code >> 3) & 1u) y = fe_neg(y);
}

// a wNAF step's entry: the GLV half comes from the code's bit 4
SP_HD SP_INLINE void pickw(const OddTable& t, uint32_t code, fe& x, fe& y) {
    pick(t, (code >> 4) & 1u, code, x, y);
}

// Scan key x P over the shared odd-digit schedule: no zero digits, so no
// infinity tracking; the accumulator starts at the first window's entries.
SP_HD SP_INLINE jac ladder(const OddTable& t, const Sched& s) {
    fe qx, qy;
    jac acc;
    pick(t, 0, s.d[0][0], acc.x, acc.y);
    acc.z = fe_one();
    pick(t, 1, s.d[1][0], qx, qy);
    acc = pt_madd(acc, qx, qy);
    SP_ROLLED
    for (int i = 1; i < ODD_WINDOWS; i++) {
        SP_ROLLED
        for (int k = 0; k < 4; k++) acc = pt_dbl(acc);
        SP_ROLLED
        for (int h = 0; h < 2; h++) {
            pick(t, h, s.d[h][i], qx, qy);
            acc = pt_madd(acc, qx, qy);
        }
    }
    // parity corrections: a half recoded as K + e subtracts e * P_h again
    SP_ROLLED
    for (int h = 0; h < 2; h++) {
        if (s.d[h][ODD_WINDOWS]) {
            fe cy = t.get(TAB_Y);
            if (s.d[h][ODD_WINDOWS + 1]) cy = fe_neg(cy);
            acc = pt_madd(acc, t.get(h ? TAB_BX : TAB_X), cy);
        }
    }
    return acc;
}

// Scan key x P over the data-driven wNAF steps. Every row of a launch
// shares the schedule, so both branches are uniform across a warp.
SP_HD SP_INLINE jac ladder_wnaf(const OddTable& t, const WSched& s) {
    jac acc;
    pickw(t, s.code[0], acc.x, acc.y);         // step 0: the init add
    acc.z = fe_one();
    SP_ROLLED
    for (int i = 1; i < WNAF_STEPS; i++) {
        uint32_t code = s.code[i];
        SP_ROLLED
        for (int k = 0; k < s.nd[i]; k++) acc = pt_dbl(acc);
        if (code >> 5) {
            fe qx, qy;
            pickw(t, code, qx, qy);
            acc = pt_madd(acc, qx, qy);
        }
    }
    return acc;
}

// The per-key ladder: the same steps as template arguments, so every
// table index and sign is a constant and a doubling run is a loop of
// known length. Its doublings and adds are calls (pt_dbl_call,
// pt_madd_call).
template <int ND, int CODE>
struct Step {};
template <class... S>
struct Steps {};

template <int ND, int CODE>
SP_HD SP_INLINE void static_step(const OddTable& t, jac& acc,
                                 Step<ND, CODE>) {
    SP_ROLLED
    for (int k = 0; k < ND; k++) acc = pt_dbl_call(acc);
    if constexpr ((CODE >> 5) != 0) {
        fe qx, qy;
        pickw(t, CODE, qx, qy);
        acc = pt_madd_call(acc, qx, qy);
    }
}

template <int CODE0, class... S>
SP_HD SP_INLINE jac ladder_static(const OddTable& t,
                                  Steps<Step<0, CODE0>, S...>) {
    static_assert((CODE0 >> 5) != 0, "step 0 must be a live add");
    jac acc;
    pickw(t, CODE0, acc.x, acc.y);
    acc.z = fe_one();
    (static_step(t, acc, S()), ...);
    return acc;
}

// The ladders as the functors scan_row() takes
struct FixedLadder {
    Sched s;
    SP_HD SP_INLINE jac operator()(const OddTable& t) const {
        return ladder(t, s);
    }
};

struct WnafLadder {
    WSched s;
    SP_HD SP_INLINE jac operator()(const OddTable& t) const {
        return ladder_wnaf(t, s);
    }
};

// The data-driven ladders from their int32 host schedules: (2, 34) odd
// digits, or (2, 54) wNAF steps (row 0 doublings, row 1 codes)
inline FixedLadder fixed_ladder(const int32_t* digits) {
    FixedLadder f;
    for (int h = 0; h < 2; h++)
        for (int i = 0; i < SCHED_COLS; i++)
            f.s.d[h][i] = (uint8_t)digits[h * SCHED_COLS + i];
    return f;
}

inline WnafLadder wnaf_ladder(const int32_t* digits) {
    WnafLadder w;
    for (int i = 0; i < WNAF_STEPS; i++) {
        w.s.nd[i] = (uint8_t)digits[i];
        w.s.code[i] = (uint8_t)digits[WNAF_STEPS + i];
    }
    return w;
}

// t x G for the 32 hash bytes (most significant first), read straight
// from the comb table: entry [i][b] = b * 2^(8(31-i)) G, x words then y
// words. b = 0 is infinity. The raw bytes are used, with no mod-n step.
SP_HD SP_INLINE jac comb_mul(const uint32_t hw[8], const uint32_t* comb,
                             bool& inf) {
    jac acc;
    acc.x = fe_zero(); acc.y = fe_zero(); acc.z = fe_zero();
    inf = true;
    SP_ROLLED
    for (int i = 0; i < 32; i++) {
        uint32_t b = (hw[i >> 2] >> (8 * (3 - (i & 3)))) & 0xFFu;
        if (b == 0) continue;
        const uint32_t* e = comb + ((size_t)i * 256 + b) * 16;
        fe qx = fe_load(e, 1), qy = fe_load(e + 8, 1);
        if (inf) {
            acc.x = qx; acc.y = qy; acc.z = fe_one();
            inf = false;
        } else {
            acc = pt_madd(acc, qx, qy);
        }
    }
    return acc;
}

// The match planes' wire (the kernel's `hi` argument): the exact wire
// ships each output's hi and lo words; a cut ships less, and compares only
// the top 32 (hi32), 16 (hi16) or 8 (hi8) bits of the candidate's upper x
// word, so its flags are a superset of the exact flags. hi16 and hi8 pack
// the top bits of the M outputs 2 or 4 to a word (unit j at word j / per,
// shift bits * (j % per)), then one validity unit: there is no ovm plane.
enum { HI_EXACT = 0, HI_32 = 1, HI_16 = 2, HI_8 = 3 };

// unit j of a row's packed hi16 / hi8 plane, word i at oh[i * stride]
SP_HD SP_INLINE uint32_t hi_unit(const uint32_t* oh, int stride, int hi,
                                 int j) {
    int lg = hi == HI_16 ? 1 : 2;               // log2 of units a word
    int bits = 32 >> lg;
    return (oh[(j >> lg) * stride] >> (bits * (j & ((1 << lg) - 1))))
           & ((1u << bits) - 1u);
}

// The row's validity word (bits 0..M-1 output valid, 30 y parity, 31 row
// valid): *ovm on the exact and hi32 wires; on hi16 / hi8 rebuilt from
// the unit after the M match units (parity at bit 14 / 6, row valid at
// 15 / 7), and ovm is not read.
SP_HD SP_INLINE uint32_t row_ovm(const uint32_t* oh, const uint32_t* ovm,
                                 int stride, int M, int hi) {
    if (hi < HI_16) return *ovm;
    int cap = hi == HI_16 ? 14 : 6;
    uint32_t u = hi_unit(oh, stride, hi, M);
    return (u & ((1u << M) - 1u)) | (((u >> cap) & 1u) << 30)
           | ((u >> (cap + 1)) << 31);
}

// Upper-64 semi-join of one candidate against the row's outputs, on the
// wire `hi` (ol is read on the exact wire only). A dead candidate
// (z == 0) never matches.
SP_HD SP_INLINE bool candidate_hits(const jac& c, const uint32_t* oh,
                                    const uint32_t* ol, int stride, int M,
                                    int hi, uint32_t ovm) {
    if (fe_is_zero(c.z)) return false;
    fe zi = fe_inv(c.z);
    fe x = fe_canon(fe_mul(c.x, fe_sqr(zi)));
    uint32_t w0 = x.v[7], w1 = x.v[6];          // bits 224..255, 192..223
    uint32_t top = hi == HI_16 ? w0 >> 16 : hi == HI_8 ? w0 >> 24 : w0;
    bool hit = false;
    SP_ROLLED
    for (int j = 0; j < M; j++) {
        if (!((ovm >> j) & 1u)) continue;
        uint32_t o = hi >= HI_16 ? hi_unit(oh, stride, hi, j)
                                 : oh[j * stride];
        hit |= o == top && (hi != HI_EXACT || ol[j * stride] == w1);
    }
    return hit;
}

// The whole per-row function, raw tweak words to the match flag.
//   lad: the scan key's ladder (FixedLadder, WnafLadder or a KeyLadder)
//   tw: the row's tweak words, word i at tw[i * stride]: x (8 words), then
//       y (8 words) when wire_xy
//   oh/ol: the row's M upper-64 match words (hi, lo), stride apart, on
//       the wire `hi` (HI_EXACT .. HI_8; ol is null on a cut)
//   M: the row's output count (on hi16 / hi8 not oh's row count)
//   ovm: the row's validity word (row_ovm): bits 0..M-1 output valid,
//       bit 30 y parity (x wire), bit 31 row valid
//   spend: x words then y words; labels: nlabels x (x words, y words)
//   t: storage for the row's odd-multiple table
template <class Ladder>
SP_HD SP_INLINE int scan_row(const uint32_t* tw, int stride, int wire_xy,
                             const uint32_t* oh, const uint32_t* ol, int M,
                             int hi, uint32_t ovm, const Ladder& lad,
                             const uint32_t* spend, const uint32_t* labels,
                             int nlabels, const uint32_t* comb,
                             const OddTable& t) {
    if (!(ovm >> 31)) return 0;                 // padding row: flag 0
    fe px = fe_load(tw, stride), py;
    if (wire_xy) {
        py = fe_load(tw + 8 * stride, stride);
    } else {
        // decompress: y = +-sqrt(x^3 + 7), sign from the wire's parity bit
        fe seven = fe_zero();
        seven.v[0] = 7;
        fe y0 = fe_sqrt(fe_add(fe_mul(fe_sqr(px), px), seven));
        uint32_t want = (ovm >> 30) & 1u;
        py = ((fe_canon(y0).v[0] & 1u) == want) ? y0 : fe_neg(y0);
    }
    build_table(px, py, t);
    jac e = lad(t);
    // to affine (zero z inverts to zero), serialize, hash
    fe zi = fe_inv(e.z);
    fe zi2 = fe_sqr(zi);
    fe ax = fe_canon(fe_mul(e.x, zi2));
    uint32_t par = fe_canon(fe_mul(e.y, fe_mul(zi, zi2))).v[0] & 1u;
    uint32_t hw[8];
    tagged_hash(ax, par, hw);
    bool oinf;
    jac o = comb_mul(hw, comb, oinf);
    // final = output + spend; candidates final, final + label_j
    fe sx = fe_load(spend, 1), sy = fe_load(spend + 8, 1);
    jac f;
    if (oinf) {
        f.x = sx; f.y = sy; f.z = fe_one();
    } else {
        f = pt_madd_call(o, sx, sy);
    }
    bool hit = candidate_hits(f, oh, ol, stride, M, hi, ovm);
    SP_ROLLED
    for (int j = 0; j < nlabels && !hit; j++) {
        const uint32_t* l = labels + j * 16;
        hit = candidate_hits(
            pt_madd_call(f, fe_load(l, 1), fe_load(l + 8, 1)), oh, ol,
            stride, M, hi, ovm);
    }
    return hit ? 1 : 0;
}

}  // namespace sp
