// Native host runtime: block-sparse structure discovery and the
// Rademacher probe draw.
//
// The structure functions are the port's own copy of the JAX package's
// fvgp_tpu/native/structure.cpp (same functions, same results).  Role:
// upstream fvGP delegates its host-side neighbor search to compiled code
// (scipy's cKDTree); here the host-side hot path at 10M-point scale is
// (1) Morton codes + argsort for spatial data ordering, (2) bounding-box
// candidate-pair enumeration over the block grid and (3) exact tile
// liveness.  These are O(N·D) / O(nb²·D) scans that numpy does
// single-threaded with temporaries; this module does them multi-threaded
// in one pass.
//
// The port alone has (4) rademacher_mt19937: the ±1 probes that
// torch.randint(0, 2, ...) draws from a CPU torch.Generator, bit for bit,
// from that generator's MT19937 state, a whole state block at a time.
//
// Exposed through ctypes; built on demand by fvgp_tpu_torch.native
// (g++ -O3 -fopenmp -shared -fPIC).  The Python layer falls back to numpy
// (to torch.randint for the probes) when the toolchain is unavailable.

#include <cstdint>
#include <cmath>
#include <algorithm>
#include <cstring>

extern "C" {

// Spread the low bits of v so consecutive bits land `ndim` apart.  Bits are
// capped so bit*ndim stays inside the 64-bit word (shift past width is UB);
// mirrors fvgp_tpu.parallel.ordering.spread_bits.
static inline uint64_t spread_bits(uint64_t v, int ndim) {
    uint64_t out = 0;
    int bits = 16 < 64 / ndim ? 16 : 64 / ndim;
    for (int bit = 0; bit < bits; ++bit) {
        out |= ((v >> bit) & 1ULL) << (bit * ndim);
    }
    return out;
}

// Morton (Z-order) codes for x (n, d), row-major.  Uses up to the first
// 8 dimensions.  Matches fvgp_tpu.parallel.ordering.morton_order exactly.
void morton_codes(const double* x, int64_t n, int64_t d, uint64_t* out) {
    int use = (int)(d < 8 ? d : 8);
    // per-dimension min/span
    double lo[8], span[8];
    for (int k = 0; k < use; ++k) { lo[k] = x[k]; span[k] = x[k]; }
    for (int64_t i = 0; i < n; ++i) {
        for (int k = 0; k < use; ++k) {
            double v = x[i * d + k];
            if (v < lo[k]) lo[k] = v;
            if (v > span[k]) span[k] = v;
        }
    }
    for (int k = 0; k < use; ++k) {
        span[k] = span[k] - lo[k];
        if (span[k] < 1e-300) span[k] = 1e-300;
    }
    const double scale = 65535.0;  // 2^16 - 1
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        uint64_t code = 0;
        for (int k = 0; k < use; ++k) {
            double u = (x[i * d + k] - lo[k]) / span[k] * scale;
            uint64_t q = (uint64_t)u;
            code |= spread_bits(q, use) << k;
        }
        out[i] = code;
    }
}

// Per-block bounding boxes of x (n, d) blocked into chunks of block_size
// consecutive rows.  lo/hi have shape (nb, d).
void block_bounds(const double* x, int64_t n, int64_t d, int64_t block_size,
                  double* lo, double* hi) {
    int64_t nb = (n + block_size - 1) / block_size;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nb; ++b) {
        int64_t start = b * block_size;
        int64_t end = std::min(n, start + block_size);
        for (int64_t k = 0; k < d; ++k) {
            double mn = x[start * d + k], mx = mn;
            for (int64_t i = start + 1; i < end; ++i) {
                double v = x[i * d + k];
                if (v < mn) mn = v;
                if (v > mx) mx = v;
            }
            lo[b * d + k] = mn;
            hi[b * d + k] = mx;
        }
    }
}

// Upper-triangle candidate block pairs whose box-to-box gap is within
// `radius`.  Returns the number of pairs written (or the required count if
// it exceeds max_pairs — caller re-allocates and calls again).
int64_t candidate_pairs(const double* lo, const double* hi, int64_t nb,
                        int64_t d, double radius, int32_t* rows,
                        int32_t* cols, int64_t max_pairs) {
    const double r2 = radius * radius;
    int64_t count = 0;
    for (int64_t i = 0; i < nb; ++i) {
        for (int64_t j = i; j < nb; ++j) {
            double dist2 = 0.0;
            for (int64_t k = 0; k < d; ++k) {
                double gap1 = lo[j * d + k] - hi[i * d + k];
                double gap2 = lo[i * d + k] - hi[j * d + k];
                double gap = gap1 > gap2 ? gap1 : gap2;
                if (gap > 0.0) dist2 += gap * gap;
                if (dist2 > r2) break;
            }
            if (dist2 <= r2) {
                if (count < max_pairs) {
                    rows[count] = (int32_t)i;
                    cols[count] = (int32_t)j;
                }
                ++count;
            }
        }
    }
    return count;
}

// Exact per-tile liveness: tiles[t] = (block rows[t], block cols[t]) is
// live iff SOME point pair sits within `radius` in whitened coordinates.
// The bounding-box prune is loose (boxes overlap even when no pair is
// inside the support); this is the tight check, with an early exit on the
// first close pair (live tiles finish almost immediately).
// `x` is the whitened (n, d) point array; padded tail handled by n.
// Exact tile liveness: a tile (bi, bj) is live iff some point pair is
// inside the support radius.  Brute force is O(B²·d) per tile and DEAD
// tiles (no early exit) dominate the loose box-pruned candidate set.  One
// level of sub-box refinement fixes that: each block is split into SUB
// index sub-ranges with their own bounding boxes (Morton ordering makes
// them spatially tight), a sub-box pair farther than the radius is skipped
// wholesale, and point pairs are only scanned inside surviving sub-pairs —
// dead tiles resolve in <= SUB² box checks instead of B² point pairs.
void tile_live(const double* x, int64_t n, int64_t d, int64_t block_size,
               const int32_t* rows, const int32_t* cols, int64_t n_tiles,
               double radius, uint8_t* out) {
    const double r2 = radius * radius;
    const int64_t nb = (n + block_size - 1) / block_size;
    const int SUB = 8;
    const int64_t sub_w = (block_size + SUB - 1) / SUB;
    const int64_t dd = d;
    // per (block, sub): lo/hi box, interleaved [lo0..lo_{d-1} hi0..hi_{d-1}]
    double* boxes = new double[(size_t)nb * SUB * 2 * dd];
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nb; ++b) {
        for (int s = 0; s < SUB; ++s) {
            double* bx = boxes + ((size_t)b * SUB + s) * 2 * dd;
            const int64_t p0 = b * block_size + s * sub_w;
            const int64_t p1 = std::min(n, std::min(p0 + sub_w,
                                                    (b + 1) * block_size));
            if (p0 >= p1) {        // empty sub-range: box that matches nothing
                for (int64_t k = 0; k < dd; ++k) {
                    bx[k] = 1e300; bx[dd + k] = -1e300;
                }
                continue;
            }
            for (int64_t k = 0; k < dd; ++k) {
                bx[k] = 1e300; bx[dd + k] = -1e300;
            }
            for (int64_t i = p0; i < p1; ++i) {
                const double* xi = x + i * dd;
                for (int64_t k = 0; k < dd; ++k) {
                    if (xi[k] < bx[k]) bx[k] = xi[k];
                    if (xi[k] > bx[dd + k]) bx[dd + k] = xi[k];
                }
            }
        }
    }
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t t = 0; t < n_tiles; ++t) {
        const int64_t bi = rows[t];
        const int64_t bj = cols[t];
        if (bi >= nb || bj >= nb) { out[t] = 0; continue; }  // sentinel
        uint8_t live = 0;
        for (int si = 0; si < SUB && !live; ++si) {
            const double* bx_i = boxes + ((size_t)bi * SUB + si) * 2 * dd;
            if (bx_i[0] > bx_i[dd]) continue;               // empty
            const int64_t i0 = std::min(n, bi * block_size + si * sub_w);
            const int64_t i1 = std::min(n, std::min(i0 + sub_w,
                                                    (bi + 1) * block_size));
            for (int sj = 0; sj < SUB && !live; ++sj) {
                const double* bx_j = boxes + ((size_t)bj * SUB + sj) * 2 * dd;
                if (bx_j[0] > bx_j[dd]) continue;           // empty
                double box_d2 = 0.0;
                for (int64_t k = 0; k < dd; ++k) {
                    double gap = 0.0;
                    if (bx_i[k] > bx_j[dd + k]) gap = bx_i[k] - bx_j[dd + k];
                    else if (bx_j[k] > bx_i[dd + k]) gap = bx_j[k] - bx_i[dd + k];
                    box_d2 += gap * gap;
                }
                if (box_d2 >= r2) continue;                 // sub-pair dead
                const int64_t j0 = std::min(n, bj * block_size + sj * sub_w);
                const int64_t j1 = std::min(n, std::min(j0 + sub_w,
                                                        (bj + 1) * block_size));
                for (int64_t i = i0; i < i1 && !live; ++i) {
                    const double* xi = x + i * dd;
                    for (int64_t j = j0; j < j1; ++j) {
                        const double* xj = x + j * dd;
                        double dist2 = 0.0;
                        for (int64_t k = 0; k < dd; ++k) {
                            const double diff = xi[k] - xj[k];
                            dist2 += diff * diff;
                            if (dist2 >= r2) break;
                        }
                        if (dist2 < r2) { live = 1; break; }
                    }
                }
            }
        }
        out[t] = live;
    }
    delete[] boxes;
}

}  // extern "C"

// Rademacher probes as torch.randint(0, 2, (count,), dtype=int8,
// generator=g) - 1 draws them from a CPU torch.Generator g: each draw is
// the low bit of one tempered 32-bit MT19937 output (torch's
// at::mt19937: decrement `left`, twist the state when it reaches 0 and
// restart at word 0, temper state[next++]).  Here the state is twisted
// 624 words at a time in three plain loops, then the block's words are
// tempered into ±1.  `state` (624 words), `left` and `next` are torch's
// own, and are advanced in place exactly as count draws would leave them;
// the caller has checked them (1 <= left, next + left - 1 <= 624).  `kind`
// is the type of `out`: 0 int8, 1 float32, 2 float64.
namespace {

const int MT_N = 624, MT_M = 397;

inline uint32_t mt_twist(uint32_t u, uint32_t v) {
    return (((u & 0x80000000U) | (v & 0x7fffffffU)) >> 1)
           ^ ((v & 1U) ? 0x9908b0dfU : 0U);
}

void mt_next_state(uint32_t* s) {
    for (int i = 0; i < MT_N - MT_M; ++i)
        s[i] = s[i + MT_M] ^ mt_twist(s[i], s[i + 1]);
    for (int i = MT_N - MT_M; i < MT_N - 1; ++i)
        s[i] = s[i + MT_M - MT_N] ^ mt_twist(s[i], s[i + 1]);
    s[MT_N - 1] = s[MT_M - 1] ^ mt_twist(s[MT_N - 1], s[0]);
}

template <typename T>
void mt_signs(const uint32_t* s, int64_t count, T* out) {
    for (int64_t i = 0; i < count; ++i) {
        uint32_t y = s[i];
        y ^= y >> 11;
        y ^= (y << 7) & 0x9d2c5680U;
        y ^= (y << 15) & 0xefc60000U;
        y ^= y >> 18;
        out[i] = (y & 1U) ? T(1) : T(-1);
    }
}

template <typename T>
void mt_draw(uint32_t* state, int32_t* left, int64_t* next, int64_t count,
             T* out) {
    // the draws left before the next twist come from the current block
    int64_t take = std::min<int64_t>(*left - 1, count);
    mt_signs(state + *next, take, out);
    *left -= (int32_t)take;
    *next += take;
    for (int64_t done = take; done < count; done += take) {
        mt_next_state(state);
        take = std::min<int64_t>(MT_N, count - done);
        mt_signs(state, take, out + done);
        // the draw that twisted leaves left = 624, each later one - 1
        *left = (int32_t)(MT_N + 1 - take);
        *next = take;
    }
}

}  // namespace

extern "C" void rademacher_mt19937(uint32_t* state, int32_t* left,
                                   int64_t* next, int64_t count, int32_t kind,
                                   void* out) {
    if (kind == 0) mt_draw(state, left, next, count, (int8_t*)out);
    else if (kind == 1) mt_draw(state, left, next, count, (float*)out);
    else mt_draw(state, left, next, count, (double*)out);
}
