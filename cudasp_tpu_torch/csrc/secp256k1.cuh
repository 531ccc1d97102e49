// secp256k1 field, point and SHA-256 code for the BIP-352 scan, plus the
// per-row function scan_row(). Shared by the CUDA kernel (scan.cu) and a
// host build (host_check.cpp, compiled with g++ by the tests), so every
// function here is plain C++ behind SP_HD: no inline PTX, no intrinsics.
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

// r += c * (2^32 + 977), c small; returns the carry out of 2^256
SP_HD SP_INLINE uint32_t fe_fold(fe& r, uint64_t c) {
    uint64_t acc = (uint64_t)r.v[0] + c * 977u;
    r.v[0] = (uint32_t)acc;
    acc = (acc >> 32) + (uint64_t)r.v[1] + c;
    r.v[1] = (uint32_t)acc;
    acc >>= 32;
    SP_UNROLL
    for (int i = 2; i < 8; i++) {
        acc += r.v[i];
        r.v[i] = (uint32_t)acc;
        acc >>= 32;
    }
    return (uint32_t)acc;
}

SP_HD SP_NOINLINE fe fe_mul(fe a, fe b) {
    uint32_t t[16];
    SP_UNROLL
    for (int i = 0; i < 16; i++) t[i] = 0;
    SP_UNROLL
    for (int i = 0; i < 8; i++) {
        uint64_t c = 0;
        SP_UNROLL
        for (int j = 0; j < 8; j++) {
            uint64_t p = (uint64_t)a.v[i] * b.v[j] + t[i + j] + c;
            t[i + j] = (uint32_t)p;
            c = p >> 32;
        }
        t[i + 8] = (uint32_t)c;
    }
    // r = lo + hi * 977 + hi * 2^32; every step < 2^43
    fe r;
    uint64_t acc = 0;
    SP_UNROLL
    for (int i = 0; i < 8; i++) {
        acc += (uint64_t)t[i] + (uint64_t)t[8 + i] * 977u
               + (i ? (uint64_t)t[7 + i] : 0);
        r.v[i] = (uint32_t)acc;
        acc >>= 32;
    }
    uint64_t top = acc + t[15];          // the part at 2^256, < 2^33
    uint32_t c2 = fe_fold(r, top);       // 0 or 1; then r < 2^66
    fe_fold(r, c2);                      // cannot carry again
    return r;
}

SP_HD SP_INLINE fe fe_sqr(fe a) { return fe_mul(a, a); }

SP_HD SP_INLINE fe fe_add(fe a, fe b) {
    fe r;
    uint64_t acc = 0;
    SP_UNROLL
    for (int i = 0; i < 8; i++) {
        acc += (uint64_t)a.v[i] + b.v[i];
        r.v[i] = (uint32_t)acc;
        acc >>= 32;
    }
    uint32_t c = fe_fold(r, acc);
    fe_fold(r, c);
    return r;
}

// r -= c * (2^32 + 977) with wrap-around; returns the borrow
SP_HD SP_INLINE uint32_t fe_unfold(fe& r, uint32_t c) {
    int64_t acc = (int64_t)r.v[0] - (int64_t)c * 977;
    r.v[0] = (uint32_t)acc;
    acc = (acc >> 32) + (int64_t)r.v[1] - c;
    r.v[1] = (uint32_t)acc;
    acc >>= 32;
    SP_UNROLL
    for (int i = 2; i < 8; i++) {
        acc += r.v[i];
        r.v[i] = (uint32_t)acc;
        acc >>= 32;
    }
    return (uint32_t)(acc & 1);
}

SP_HD SP_INLINE fe fe_sub(fe a, fe b) {
    fe r;
    int64_t acc = 0;
    SP_UNROLL
    for (int i = 0; i < 8; i++) {
        acc += (int64_t)a.v[i] - b.v[i];
        r.v[i] = (uint32_t)acc;
        acc >>= 32;
    }
    // a borrow wrapped by 2^256 == 2^32 + 977: take that back out, twice
    // at most (the second time r is tiny)
    uint32_t br = fe_unfold(r, (uint32_t)(acc & 1));
    fe_unfold(r, br);
    return r;
}

SP_HD SP_INLINE fe fe_neg(fe a) { return fe_sub(fe_zero(), a); }

SP_HD SP_INLINE fe fe_canon(fe a) {
    fe d;
    int64_t acc = 0;
    SP_UNROLL
    for (int i = 0; i < 8; i++) {
        acc += (int64_t)a.v[i] - P_WORDS[i];
        d.v[i] = (uint32_t)acc;
        acc >>= 32;
    }
    return acc ? a : d;                  // borrow: a < p already
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

// libsecp256k1's addition chain: x223 = a^(2^223 - 1) and the pieces
SP_HD SP_INLINE void fe_x223(fe a, fe& x2, fe& x22, fe& x223) {
    x2 = fe_mul(fe_sqr(a), a);
    fe x3 = fe_mul(fe_sqr(x2), a);
    fe x6 = fe_mul(fe_sqr_n(x3, 3), x3);
    fe x9 = fe_mul(fe_sqr_n(x6, 3), x3);
    fe x11 = fe_mul(fe_sqr_n(x9, 2), x2);
    x22 = fe_mul(fe_sqr_n(x11, 11), x11);
    fe x44 = fe_mul(fe_sqr_n(x22, 22), x22);
    fe x88 = fe_mul(fe_sqr_n(x44, 44), x44);
    fe x176 = fe_mul(fe_sqr_n(x88, 88), x88);
    fe x220 = fe_mul(fe_sqr_n(x176, 44), x44);
    x223 = fe_mul(fe_sqr_n(x220, 3), x3);
}

// a^(p-2); zero inverts to zero
SP_HD SP_NOINLINE fe fe_inv(fe a) {
    fe x2, x22, x223;
    fe_x223(a, x2, x22, x223);
    fe t = fe_mul(fe_sqr_n(x223, 23), x22);
    t = fe_mul(fe_sqr_n(t, 5), a);
    t = fe_mul(fe_sqr_n(t, 3), x2);
    return fe_mul(fe_sqr_n(t, 2), a);
}

// a^((p+1)/4): the square root when a is a quadratic residue
SP_HD SP_NOINLINE fe fe_sqrt(fe a) {
    fe x2, x22, x223;
    fe_x223(a, x2, x22, x223);
    fe t = fe_mul(fe_sqr_n(x223, 23), x22);
    t = fe_mul(fe_sqr_n(t, 6), x2);
    return fe_sqr_n(t, 2);
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

// ---------------------------------------------------------------------------
// SHA-256: one compression from the tag midstate over 02/03 || x || 0^4
// ---------------------------------------------------------------------------

SP_HD SP_INLINE uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

// xc: canonical affine x (LE words); parity: y's low bit. h: 8 BE words.
SP_HD SP_INLINE void tagged_hash(const fe& xc, uint32_t parity, uint32_t h[8]) {
    uint32_t xw[8];                      // big-endian words of x
    SP_UNROLL
    for (int i = 0; i < 8; i++) xw[i] = xc.v[7 - i];
    uint32_t w[64];
    w[0] = ((0x02u + parity) << 24) | (xw[0] >> 8);
    SP_UNROLL
    for (int i = 1; i < 8; i++) w[i] = (xw[i - 1] << 24) | (xw[i] >> 8);
    w[8] = (xw[7] & 0xFFu) << 24;
    w[9] = 0x00800000u;
    SP_UNROLL
    for (int i = 10; i < 15; i++) w[i] = 0;
    w[15] = (64 + 37) * 8;
    SP_UNROLL
    for (int t = 16; t < 64; t++) {
        uint32_t s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3);
        uint32_t s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10);
        w[t] = w[t - 16] + s0 + w[t - 7] + s1;
    }
    uint32_t a = TAG_MIDSTATE[0], b = TAG_MIDSTATE[1], c = TAG_MIDSTATE[2],
             d = TAG_MIDSTATE[3], e = TAG_MIDSTATE[4], f = TAG_MIDSTATE[5],
             g = TAG_MIDSTATE[6], hh = TAG_MIDSTATE[7];
    SP_UNROLL
    for (int t = 0; t < 64; t++) {
        uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = hh + s1 + ch + SHA_K[t] + w[t];
        uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
        hh = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + s0 + maj;
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
// half-2 table); y's sign is applied at pick time.
struct OddTable {
    fe x[8], bx[8], y[8];
};

SP_HD SP_INLINE void build_table(fe px, fe py, OddTable& t) {
    // Co-Z chain: 2P and P aligned at 2P's z, then each ZADDU emits
    // (2m+1) P and re-expresses 2P at the new z
    jac p0;
    p0.x = px; p0.y = py; p0.z = fe_one();
    jac d2 = pt_dbl(p0);
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
    t.x[0] = px; t.y[0] = py; t.bx[0] = fe_mul(beta, px);
    SP_ROLLED
    for (int m = 6; m >= 0; m--) {
        fe s = nz[m] ? fe_one() : cz[m];
        fe zi = fe_mul(run, pre[m]);
        run = fe_mul(run, s);
        if (nz[m]) zi = fe_zero();
        fe zi2 = fe_sqr(zi);
        fe ax = fe_mul(cx[m], zi2);
        t.x[m + 1] = ax;
        t.y[m + 1] = fe_mul(cy[m], fe_mul(zi, zi2));
        t.bx[m + 1] = fe_mul(beta, ax);
    }
}

SP_HD SP_INLINE void pick(const OddTable& t, int h, uint32_t code, fe& x,
                          fe& y) {
    int idx = code & 7;
    x = h ? t.bx[idx] : t.x[idx];
    y = ((code >> 3) & 1u) ? fe_neg(t.y[idx]) : t.y[idx];
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
            fe cy = s.d[h][ODD_WINDOWS + 1] ? fe_neg(t.y[0]) : t.y[0];
            acc = pt_madd(acc, h ? t.bx[0] : t.x[0], cy);
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

// The per-key ladder: the same steps as template arguments, so doubling
// runs are straight-line and every table index and sign is a constant.
// Doublings and adds stay calls: inlined into ~170 steps they would
// multiply ptxas time and the code size.
template <int ND, int CODE>
struct Step {};
template <class... S>
struct Steps {};

SP_HD SP_NOINLINE jac pt_dbl_call(jac p) { return pt_dbl(p); }
SP_HD SP_NOINLINE jac pt_madd_call(jac p, fe qx, fe qy) {
    return pt_madd(p, qx, qy);
}

template <int ND, int CODE>
SP_HD SP_INLINE void static_step(const OddTable& t, jac& acc,
                                 Step<ND, CODE>) {
    SP_UNROLL
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
template <class Ladder>
SP_HD SP_INLINE int scan_row(const uint32_t* tw, int stride, int wire_xy,
                             const uint32_t* oh, const uint32_t* ol, int M,
                             int hi, uint32_t ovm, const Ladder& lad,
                             const uint32_t* spend, const uint32_t* labels,
                             int nlabels, const uint32_t* comb) {
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
    OddTable t;
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
        f = pt_madd(o, sx, sy);
    }
    bool hit = candidate_hits(f, oh, ol, stride, M, hi, ovm);
    SP_ROLLED
    for (int j = 0; j < nlabels && !hit; j++) {
        const uint32_t* l = labels + j * 16;
        hit = candidate_hits(pt_madd(f, fe_load(l, 1), fe_load(l + 8, 1)),
                             oh, ol, stride, M, hi, ovm);
    }
    return hit ? 1 : 0;
}

}  // namespace sp
