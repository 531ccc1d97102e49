// The port's host packer: scan inputs to the scan kernel's wire planes in
// one pass, as a plain C ABI loaded with ctypes (io/native.py builds it
// with g++ at first use). Counterpart of the JAX package's native ingest
// library (csrc/ingest.cpp: cudasp_pack_points, cudasp_pack_outputs,
// cudasp_count_chunks), in the port's own formats: tweak points as raw
// little-endian 32-bit words (the kernel's layout), not 13-bit limbs.
//
// cudasp_pack_wire does what ops/kernels.py pack_batch_arrays and the
// executor's staging copy did in several numpy passes: one batch's rows
// straight into the planes of one upload mode, and the block mask, in a
// caller's buffer (a pinned staging slot on the card's path). Every plane
// is `width` lanes; lane l holds row a + l; lanes past b - a are zero.
#include <stdint.h>
#include <string.h>

#include <thread>
#include <vector>

namespace {

enum Mode { FULL = 0, FULL64 = 1, HI32 = 2, HI16 = 3, HI8 = 4 };

inline uint32_t le32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16)
           | ((uint32_t)p[3] << 24);
}

struct Wire {
    const uint8_t* blobs;      // (n, 64): LE x || LE y
    const uint8_t* row_valid;  // (n,)
    const int32_t* hi;         // (n, M) upper int32 of each output
    const int32_t* lo;         // (n, M) lower int32
    const uint8_t* valid;      // (n, M)
    int64_t a, b;              // the batch's rows
    int M, mode;
    int64_t width;
    uint32_t* out;             // (rows(mode, M) + 1, width)
};

// hi16 / hi8: match bits a unit, units a word, output-count cap
void unit_shape(int mode, int& bits, int& per, int& cap) {
    bits = mode == HI16 ? 16 : 8;
    per = mode == HI16 ? 2 : 4;
    cap = mode == HI16 ? 14 : 6;
}

int plane_rows(int mode, int M) {
    int tw = mode == FULL64 ? 16 : 8;
    if (mode == FULL || mode == FULL64) return tw + 2 * M + 1;
    if (mode == HI32) return tw + M + 1;
    int bits, per, cap;
    unit_shape(mode, bits, per, cap);
    return tw + (M + per) / per;
}

const int TILE = 256;        // lanes a tile
const int MAX_ROWS = 16 + 2 * 30 + 1;

// lanes [l0, l1) of every plane, a tile at a time: a tile's lanes are
// built in a local buffer, a row of it per plane, and each row goes out
// as one contiguous run (the planes are `width` words apart, so writing
// lane by lane would touch every plane's line at once, and at a width of
// a power of two those lines alias to one cache set)
void pack_lanes(const Wire& w, int64_t l0, int64_t l1) {
    const int64_t W = w.width, k = w.b - w.a;
    const int M = w.M;
    const int nw = w.mode == FULL64 ? 16 : 8;
    const int rows = plane_rows(w.mode, M);
    int bits = 0, per = 1, cap = 0;
    if (w.mode == HI16 || w.mode == HI8) unit_shape(w.mode, bits, per, cap);
    uint32_t tile[MAX_ROWS][TILE];
    for (int64_t t0 = l0; t0 < l1; t0 += TILE) {
        const int n = (int)(l1 - t0 < TILE ? l1 - t0 : TILE);
        int live = (int)(k - t0 < n ? k - t0 : n);
        if (live < 0) live = 0;
        for (int q = 0; q < rows; q++)
            for (int c = live; c < n; c++) tile[q][c] = 0;
        for (int c = 0; c < live; c++) {
            const int64_t r = w.a + t0 + c;
            const uint8_t* blob = w.blobs + r * 64;
            for (int i = 0; i < nw; i++) tile[i][c] = le32(blob + 4 * i);
            const int32_t* h = w.hi + r * M;
            const uint8_t* v = w.valid + r * M;
            uint32_t ovm = 0;
            for (int j = 0; j < M; j++) ovm |= (uint32_t)(v[j] != 0) << j;
            const uint32_t parity = blob[32] & 1u;
            const uint32_t on = w.row_valid[r] != 0;
            ovm |= (parity << 30) | (on << 31);
            if (w.mode == FULL || w.mode == FULL64) {
                const int32_t* lo = w.lo + r * M;
                for (int j = 0; j < M; j++) tile[nw + j][c] = (uint32_t)h[j];
                for (int j = 0; j < M; j++)
                    tile[nw + M + j][c] = (uint32_t)lo[j];
                tile[nw + 2 * M][c] = ovm;
            } else if (w.mode == HI32) {
                for (int j = 0; j < M; j++) tile[nw + j][c] = (uint32_t)h[j];
                tile[nw + M][c] = ovm;
            } else {
                // M match units (the top bits of each value), then the
                // validity unit: bits 0..M-1 valid, cap parity, cap+1 live
                for (int q = nw; q < rows; q++) tile[q][c] = 0;
                for (int j = 0; j <= M; j++) {
                    uint32_t u = j < M ? (uint32_t)h[j] >> (32 - bits)
                                       : (ovm & ((1u << M) - 1u))
                                             | (parity << cap)
                                             | (on << (cap + 1));
                    tile[nw + j / per][c] |= u << (bits * (j % per));
                }
            }
        }
        for (int q = 0; q < rows; q++)
            memcpy(w.out + q * W + t0, tile[q], n * sizeof(uint32_t));
    }
}

}  // namespace

extern "C" {

// Planes and block mask of one batch. mode: 0 full, 1 full64, 2 hi32,
// 3 hi16, 4 hi8. The block-mask row follows the planes: word i = 1 when
// block i (block_rows lanes) starts before n_live, for i < width /
// block_rows, then zeros. threads > 1 splits the lanes over that many
// threads. Returns 0, or -1 when the arguments do not fit (M above the
// mode's cap or 30, a width under b - a or not a multiple of block_rows).
int cudasp_pack_wire(const uint8_t* blobs, const uint8_t* row_valid,
                     const int32_t* hi, const int32_t* lo,
                     const uint8_t* valid, int64_t a, int64_t b, int M,
                     int mode, int64_t width, int block_rows, int64_t n_live,
                     uint32_t* out, int threads) {
    if (mode < FULL || mode > HI8 || M < 1 || M > 30 || b < a
        || block_rows < 1 || width < b - a || width % block_rows
        || (mode == HI16 && M > 14) || (mode == HI8 && M > 6))
        return -1;
    Wire w{blobs, row_valid, hi, lo, valid, a, b, M, mode, width, out};
    const int rows = plane_rows(mode, M);
    uint32_t* bm = out + (int64_t)rows * width;
    const int64_t nbl = width / block_rows;
    for (int64_t i = 0; i < width; i++)
        bm[i] = i < nbl && i * block_rows < n_live ? 1u : 0u;
    if (threads < 2 || width < 4096) {
        pack_lanes(w, 0, width);
        return 0;
    }
    // contiguous lane ranges of whole tiles, so no two threads share a
    // cache line of a plane
    int64_t step = ((width + threads - 1) / threads + TILE - 1) / TILE
                   * TILE;
    std::vector<std::thread> pool;
    for (int64_t l0 = step; l0 < width; l0 += step)
        pool.emplace_back(pack_lanes, std::cref(w), l0,
                          l0 + step < width ? l0 + step : width);
    pack_lanes(w, 0, step < width ? step : width);
    for (auto& t : pool) t.join();
    return 0;
}

// (n, 64) point blobs -> x and y as (8, n) uint32 word planes.
void cudasp_pack_points(const uint8_t* blobs, int64_t n, uint32_t* out_x,
                        uint32_t* out_y) {
    for (int64_t r = 0; r < n; r++) {
        const uint8_t* blob = blobs + r * 64;
        for (int i = 0; i < 8; i++) {
            out_x[i * n + r] = le32(blob + 4 * i);
            out_y[i * n + r] = le32(blob + 32 + 4 * i);
        }
    }
}

// Ragged outputs (CSR) -> padded (n_virtual, max_outputs) hi / lo planes
// and a validity mask for a virtual-row expansion: src[v] is the source
// row of virtual row v, chunk[v] its chunk within that row.
void cudasp_pack_outputs(const int64_t* flat, const int64_t* offsets,
                         const int64_t* src, const int64_t* chunk,
                         int64_t n_virtual, int64_t max_outputs,
                         int32_t* out_hi, int32_t* out_lo,
                         uint8_t* out_valid) {
    for (int64_t v = 0; v < n_virtual; v++) {
        const int64_t row = src[v];
        const int64_t begin = offsets[row] + chunk[v] * max_outputs;
        int64_t len = offsets[row + 1] - begin;
        if (len > max_outputs) len = max_outputs;
        for (int64_t m = 0; m < max_outputs; m++) {
            const bool ok = m < len;
            const uint64_t u = ok ? (uint64_t)flat[begin + m] : 0;
            out_hi[v * max_outputs + m] = (int32_t)(uint32_t)(u >> 32);
            out_lo[v * max_outputs + m] = (int32_t)(uint32_t)u;
            out_valid[v * max_outputs + m] = ok ? 1 : 0;
        }
    }
}

// Chunks a row takes at max_outputs values a chunk (nch[r]); returns the
// total, the number of virtual rows.
int64_t cudasp_count_chunks(const int64_t* offsets, int64_t n_rows,
                            int64_t max_outputs, int64_t* nch) {
    int64_t total = 0;
    for (int64_t r = 0; r < n_rows; r++) {
        const int64_t len = offsets[r + 1] - offsets[r];
        nch[r] = (len + max_outputs - 1) / max_outputs;
        total += nch[r];
    }
    return total;
}

}  // extern "C"
