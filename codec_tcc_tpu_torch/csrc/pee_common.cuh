// Shared pieces of the PEE kernels K3 (pee_embed.cu) and K4 (pee_extract.cu).
//
// Both are ONE launch per pass over a (B, H, W) batch: a block takes a tile
// of PEE_TILE_PX consecutive raster pixels of one image by ticket, each of
// its PEE_THREADS threads owns a run of PEE_RUN consecutive pixels in
// registers, and the tile's offset into the image's global rank comes from
// a decoupled look-back over the status words of the tiles before it.
//
// The geometry is the closed form of codec_tcc_tpu/ops/pallas_pee.py
// `_geometry`: the in-set pixels of a pass are the interior pixels of one
// checkerboard colour, and their count before any raster position is a
// function of (y, x) alone, so no scan is needed for it.
//
// Band mode (BAND = true; pallas_pee.py `pos_base`/`rank_base`): the band
// kernels of pee_embed.cu and pee_extract.cu run on a band of lh rows of an
// image h rows tall, whose first row is global row row0. The geometry takes
// the global row, the neighbours of the band's first and last rows come
// from the rows `top` and `bot` (the next bands' edge rows), and a run stops
// at the band's end. They take no ticket and no look-back: a count launch
// writes each tile's count, and the apply launch's block sums the counts of
// the tiles before its own (pee_tiles_before).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PEE_THREADS 256
#define PEE_RUN 16   // pixels per thread: one 16-bit mask, 16-byte vectors
#define PEE_TILE_PX (PEE_THREADS * PEE_RUN)   // exported as pee_tile_pixels()

// Tiles per image.
static inline long long pee_tiles(int h, int w) {
    return ((long long)h * w + PEE_TILE_PX - 1) / PEE_TILE_PX;
}

// The arguments every band launch checks: int pixel indices as for whole
// images (n + w plus a tile, and the image's set ranks, below 2**31), at
// most 65535 bands (grid.y), rows [row0, row0 + lh) inside the image, both
// halo rows.
static inline bool pee_band_args_ok(int batch, int lh, int h, int w,
                                    int row0, int parity, int t,
                                    const void* top, const void* bot) {
    return batch >= 1 && batch <= 65535 && h >= 1 && w >= 1 && lh >= 1 &&
           row0 >= 0 && lh <= h - row0 && (parity == 0 || parity == 1) &&
           t >= 1 && ((long long)h + 1) * w <= 0x7fffffffLL - PEE_TILE_PX &&
           top && bot;
}

// Interior pixel of checkerboard colour `parity`: the pixels a pass may touch.
__device__ __forceinline__ bool pee_in_set(int y, int x, int h, int w,
                                           int parity) {
    return y >= 1 && y <= h - 2 && x >= 1 && x <= w - 2 &&
           ((y + x) & 1) == parity;
}

// The number of in-set pixels before raster position (y, x), 0 <= x < w,
// any y >= 0 (ops/pee.py `_band_geometry` counts the same set). Interior rows
// alternate between (w - 1) / 2 and (w - 2) / 2 in-set pixels; inside an
// interior row they are the odd or the even columns in [1, w - 2].
__device__ __forceinline__ int pee_set_count_before(int y, int x, int h,
                                                    int w, int parity) {
    const int m = max(min(y - 1, h - 2), 0);   // interior rows before y
    const int n_q1 = (parity & 1) == 0 ? (m + 1) / 2 : m / 2;
    const int n_q0 = m - n_q1;
    const int row_excl = n_q1 * ((w - 1) / 2) + n_q0 * ((w - 2) / 2);
    if (y < 1 || y > h - 2) return row_excl;
    const int last = min(x - 1, w - 2);   // >= -1; the in-row columns <= it
    return row_excl + (((parity + y) & 1) == 1 ? (last + 1) / 2 : last / 2);
}

// Inclusive raster rank of in-set pixel (y, x) among the in-set pixels.
__device__ __forceinline__ int pee_set_rank(int y, int x, int h, int w,
                                            int parity) {
    return pee_set_count_before(y, x, h, w, parity) + 1;
}

// A tile's status word packs {flag, value} into 64 bits, so that one store
// publishes both and no reader sees half of it. Flag 0 (the word as zeroed
// before the launch): nothing yet. The word carries its own value and
// publishes no other data, so its store needs no fence before it; the
// volatile accesses go to L2, where all blocks see the same word.
#define PEE_ST_AGGREGATE (1ull << 32)   // value: the tile's own count
#define PEE_ST_PREFIX (2ull << 32)      // value: the count up to and with it

__device__ __forceinline__ void pee_st_publish(unsigned long long* st,
                                               unsigned long long word) {
    *(volatile unsigned long long*)st = word;
}

__device__ __forceinline__ unsigned long long pee_st_read(
    const unsigned long long* st) {
    return *(const volatile unsigned long long*)st;
}

// This block's tile in start order: blocks take tickets from a zeroed
// counter as they start, so a tile only ever waits on tiles that are
// already running (blockIdx order promises nothing). Every thread of the
// block must call it (it holds a barrier).
__device__ __forceinline__ int pee_take_ticket(unsigned* ticket, int* slot) {
    if (threadIdx.x == 0) *slot = (int)atomicAdd(ticket, 1u);
    __syncthreads();
    return *slot;
}

// Exclusive prefix of `v` over the block's threads in thread order, and the
// block's total: a warp shuffle scan, then a scan of the THREADS / 32 warp
// totals in `warp_tot` (shared). One barrier; `warp_tot` must not be
// rewritten after it by the same block.
template <int THREADS>
__device__ __forceinline__ int pee_block_excl_scan(int v, int* warp_tot,
                                                   int* total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int x = v;   // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    int before = 0;
    int sum = 0;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) {
        const int c = warp_tot[k];
        before += k < warp ? c : 0;
        sum += c;
    }
    *total = sum;
    return before + x - v;
}

// The sum of `v` over the block's threads, returned to every thread: a warp
// reduction, then the THREADS / 32 warp sums in `warp_tot` (shared). One
// barrier; `warp_tot` must not be rewritten after it by the same block.
template <int THREADS>
__device__ __forceinline__ int pee_block_sum(int v, int* warp_tot) {
    const unsigned s = __reduce_add_sync(0xffffffffu, (unsigned)v);
    if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = (int)s;
    __syncthreads();
    int sum = 0;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) sum += warp_tot[k];
    return sum;
}

// This thread's part of the sum of counts[0 .. tile), the per-tile counts
// a band's count launch wrote (at most 1 + tile / PEE_THREADS loads, all
// issued before any pixel is used); pee_block_sum of the parts is the
// number of counted pixels in the tiles before this one.
__device__ __forceinline__ int pee_tiles_before_part(
    const int* __restrict__ counts, int tile) {
    int v = 0;
    for (int j = threadIdx.x; j < tile; j += PEE_THREADS) v += __ldg(counts + j);
    return v;
}

// Exclusive prefix of tile `tile` among the tiles of one image, whose status
// words start at `st`, given the tile's own count `agg`. Publishes the
// tile's aggregate at once and its inclusive prefix when known. Called by
// all 32 lanes of one warp: lane l reads the status of tile (last - l); the
// warp waits only until the tiles from `last` back to the nearest prefix
// (all 32 if there is none) are filled, sums them, and moves 32 tiles back
// if there was no prefix. Tile 0 of every image publishes its prefix at
// once, so the walk ends at the image's start.
__device__ __forceinline__ unsigned pee_lookback(unsigned long long* st,
                                                 int tile, unsigned agg) {
    const int lane = threadIdx.x & 31;
    if (tile == 0) {
        if (lane == 0) pee_st_publish(st, PEE_ST_PREFIX | agg);
        return 0;
    }
    if (lane == 0) pee_st_publish(st + tile, PEE_ST_AGGREGATE | agg);
    unsigned excl = 0;
    for (int last = tile - 1;; last -= 32) {
        const int i = last - lane;
        unsigned long long word;
        unsigned prefixes;
        for (;;) {
            word = i >= 0 ? pee_st_read(st + i) : PEE_ST_PREFIX;  // before 0
            prefixes = __ballot_sync(0xffffffffu, (word >> 32) == 2);
            const unsigned empty =
                __ballot_sync(0xffffffffu, (word >> 32) == 0);
            // lanes 0 .. the nearest prefix, or all of them
            const unsigned needed =
                prefixes ? prefixes ^ (prefixes - 1) : 0xffffffffu;
            if (!(empty & needed)) break;
            __nanosleep(32);
        }
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        excl += __reduce_add_sync(0xffffffffu,
                                  lane <= stop ? (unsigned)word : 0u);
        if (prefixes) break;
    }
    if (lane == 0) pee_st_publish(st + tile, PEE_ST_PREFIX | (excl + agg));
    return excl;
}

// Runs of RUN consecutive elements. A run moves as 16-byte vectors where
// its address is 16-byte aligned and it lies in range, else one element at
// a time. The alignment follows the data (an image of a batch starts at
// b * H * W, a neighbour row at +-W), not the shape.

// True when the run at `start` and the runs at start -+ w all lie in
// [0, n) and are 16-byte aligned (int indices: the launcher keeps
// n + w + RUN in range).
template <typename T, int RUN>
__device__ __forceinline__ bool pee_rows_vectorizable(const T* base,
                                                      int start, int w,
                                                      int n) {
    return start >= w && start + w + RUN <= n &&
           (((uintptr_t)(base + start) | ((uintptr_t)w * sizeof(T))) & 15) ==
               0;
}

template <typename T, int RUN>
__device__ __forceinline__ void pee_load_vec(const T* __restrict__ p,
                                             T (&v)[RUN]) {
    constexpr int PER = 16 / (int)sizeof(T);
    static_assert(RUN % PER == 0, "a run is a whole number of vectors");
#pragma unroll
    for (int j = 0; j < RUN / PER; ++j) {
        union { uint4 q; T e[PER]; } u;
        u.q = __ldg(reinterpret_cast<const uint4*>(p) + j);
#pragma unroll
        for (int k = 0; k < PER; ++k) v[j * PER + k] = u.e[k];
    }
}

// Elements [start, start + RUN) of `base`, the ones outside [0, n) read as 0.
template <typename T, int RUN>
__device__ __forceinline__ void pee_load_scalar(const T* __restrict__ base,
                                                int start, int n,
                                                T (&v)[RUN]) {
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
        const int i = start + k;
        v[k] = (i >= 0 && i < n) ? base[i] : T(0);
    }
}

// Elements [start, start + RUN) of a band of n elements in rows of w, with
// the row above it at indices -w .. -1 (`top`) and the row below it at
// n .. n + w - 1 (`bot`); the ones further out read as 0.
template <typename T, int RUN>
__device__ __forceinline__ void pee_load_band_scalar(
    const T* __restrict__ base, const T* __restrict__ top,
    const T* __restrict__ bot, int start, int n, int w, T (&v)[RUN]) {
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
        const int i = start + k;
        v[k] = i < -w       ? T(0)
               : i < 0      ? top[i + w]
               : i < n      ? base[i]
               : i < n + w  ? bot[i - n]
                            : T(0);
    }
}

// The run of RUN pixels at p0 (< n) of a band of n pixels in rows of w, the
// runs above and below it and its row neighbours, all loads issued before
// any is used: 16-byte vectors where the three rows lie inside the band
// (pee_rows_vectorizable), else scalar loads, the band's first and last
// rows taking their neighbours from `top` and `bot`. Returns whether the
// loads were vectors.
template <typename T, int RUN>
__device__ __forceinline__ bool pee_load_band_run(
    const T* __restrict__ im, const T* __restrict__ top,
    const T* __restrict__ bot, int p0, int n, int w, T (&c)[RUN],
    T (&up)[RUN], T (&dn)[RUN], int& left, int& right) {
    if (pee_rows_vectorizable<T, RUN>(im, p0, w, n)) {
        left = im[p0 - 1];
        right = im[p0 + RUN];
        pee_load_vec(im + p0, c);
        pee_load_vec(im + p0 - w, up);
        pee_load_vec(im + p0 + w, dn);
        return true;
    }
    // an in-set pixel is interior, so its row neighbours are in range
    left = p0 > 0 ? im[p0 - 1] : 0;
    right = p0 + RUN < n ? im[p0 + RUN] : 0;
    pee_load_scalar(im, p0, n, c);
    pee_load_band_scalar(im, top, bot, p0 - w, n, w, up);
    pee_load_band_scalar(im, top, bot, p0 + w, n, w, dn);
    return false;
}

// Elements [start, start + RUN) of `v` into `base` (start >= 0), the ones at
// or past n dropped.
template <typename T, int RUN>
__device__ __forceinline__ void pee_store_run(T* __restrict__ base, int start,
                                              int n, const T (&v)[RUN]) {
    constexpr int PER = 16 / (int)sizeof(T);
    static_assert(RUN % PER == 0, "a run is a whole number of vectors");
    T* p = base + start;
    if (start + RUN <= n && ((uintptr_t)p & 15) == 0) {
#pragma unroll
        for (int j = 0; j < RUN / PER; ++j) {
            union { uint4 q; T e[PER]; } u;
#pragma unroll
            for (int k = 0; k < PER; ++k) u.e[k] = v[j * PER + k];
            reinterpret_cast<uint4*>(p)[j] = u.q;
        }
    } else {
#pragma unroll
        for (int k = 0; k < RUN; ++k) {
            if (start + k < n) p[k] = v[k];
        }
    }
}

// Bit k of `mask` as byte k (0 or 1) of a run of 16 bytes at `base + start`,
// the ones at or past n dropped.
__device__ __forceinline__ void pee_store_mask16(uint8_t* __restrict__ base,
                                                 int start, int n,
                                                 unsigned mask) {
    uint8_t* p = base + start;
    if (start + 16 <= n && ((uintptr_t)p & 15) == 0) {
        uint4 q;
        // 4 bits -> 4 bytes: x * 0x204081 puts bit i at bit 8i (no carries)
        q.x = ((mask & 0xfu) * 0x204081u) & 0x01010101u;
        q.y = (((mask >> 4) & 0xfu) * 0x204081u) & 0x01010101u;
        q.z = (((mask >> 8) & 0xfu) * 0x204081u) & 0x01010101u;
        q.w = (((mask >> 12) & 0xfu) * 0x204081u) & 0x01010101u;
        *reinterpret_cast<uint4*>(p) = q;
    } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            if (start + k < n) p[k] = (mask >> k) & 1u;
        }
    }
}

// Bit k set where byte start + k of `base` is nonzero, for the 16 bytes at
// `start`; the ones at or past n read as 0.
__device__ __forceinline__ unsigned pee_load_nonzero16(
    const uint8_t* __restrict__ base, int start, int n) {
    const uint8_t* p = base + start;
    if (start + 16 <= n && ((uintptr_t)p & 15) == 0) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        unsigned mask = 0;
        const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const unsigned v = words[j];
            // bit 7 of each nonzero byte, then bits 7, 15, 23, 31 gathered
            // into the top nibble: 0x10204080 shifts bit 8i to bit 28 + i,
            // and its other products land below bit 28 without carries
            const unsigned hi = (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) &
                                0x80808080u;
            mask |= ((hi >> 7) * 0x10204080u >> 28) << (4 * j);
        }
        return mask;
    }
    unsigned mask = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        if (start + k < n && p[k] != 0) mask |= 1u << k;
    }
    return mask;
}

// The in-set pixels of the run of RUN pixels at raster position p0 (< n), as
// bit k for pixel p0 + k, and the run's row y0 and column x0 (one division).
// Inside one interior row they are every other pixel from k0 = (x0 + y0 +
// parity) & 1, and `mode` becomes k0 where the caller's loads allow it to
// take only those (`vec`); elsewhere, and for a run that crosses a row end,
// `mode` is 2: pixel by pixel. BAND: p0 and n are the band's, y0 comes back
// global (row0 + the local row) and a run stops at the band's end.
template <int RUN, bool BAND = false>
__device__ __forceinline__ unsigned pee_run_in_set(int p0, int h, int w,
                                                   int parity, bool vec,
                                                   int& mode, int& y0,
                                                   int& x0, int row0 = 0,
                                                   int n = 0) {
    static_assert(RUN <= 16, "masks of 32 bits, with room for 2u << k");
    y0 = p0 / w;
    x0 = p0 - y0 * w;
    if (BAND) y0 += row0;
    mode = 2;
    unsigned in_set = 0;
    if (x0 + RUN <= w) {
        const int lo = max(1 - x0, 0);              // first k with x >= 1
        const int hi = min(w - 2 - x0, RUN - 1);    // last k, x <= w - 2
        if (y0 >= 1 && y0 <= h - 2 && lo <= hi) {
            const int k0 = (x0 + y0 + parity) & 1;
            in_set = (0xffffffffu >> (31 - hi)) & (0xffffffffu << lo) &
                     (k0 ? 0xaaaaaaaau : 0x55555555u);
            if (vec) mode = k0;
        }
    } else {
        int y = y0, x = x0;
#pragma unroll
        for (int k = 0; k < RUN; ++k) {   // false past n (y >= h)
            if (pee_in_set(y, x, h, w, parity) && (!BAND || p0 + k < n)) {
                in_set |= 1u << k;
            }
            if (++x == w) {
                x = 0;
                ++y;
            }
        }
    }
    return in_set;
}
