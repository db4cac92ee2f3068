// Shared pieces of the PEE kernels (pee_embed.cu, pee_extract.cu).
//
// The three-launch scan (pee_extract.cu) walks each image of a (B, H, W)
// batch in raster tiles of PEE_TILE_PX pixels: block (tile, b) owns pixels
// [tile * PEE_TILE_PX, (tile + 1) * PEE_TILE_PX) of image b and visits them
// in PEE_ROUNDS rounds of PEE_THREADS consecutive pixels, so every load and
// store of a round is coalesced and raster order inside a block is (round,
// warp, lane). The single-pass pieces at the end (pee_embed.cu) give each
// thread a run of consecutive pixels instead and find a tile's rank offset
// by a decoupled look-back, in one launch.
//
// The geometry is the closed form of codec_tcc_tpu/ops/pallas_pee.py
// `_geometry`: the in-set pixels of a pass are the interior pixels of one
// checkerboard colour, and their inclusive raster rank among the set is a
// function of (y, x) alone, so no scan is needed for it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PEE_THREADS 256
#define PEE_ROUNDS 16
#define PEE_TILE_PX (PEE_THREADS * PEE_ROUNDS)   // exported as pee_tile_px()
#define PEE_WARPS (PEE_THREADS / 32)
#define PEE_SCAN_THREADS 1024

// Interior pixel of checkerboard colour `parity`: the pixels a pass may touch.
__device__ __forceinline__ bool pee_in_set(int y, int x, int h, int w,
                                           int parity) {
    return y >= 1 && y <= h - 2 && x >= 1 && x <= w - 2 &&
           ((y + x) & 1) == parity;
}

// Inclusive raster rank of in-set pixel (y, x) among the in-set pixels
// (ops/pee.py `_set_rank`); meaningful on in-set pixels only, where every
// term below is >= 0.
__device__ __forceinline__ int pee_set_rank(int y, int x, int h, int w,
                                            int parity) {
    const int m = min(max(y - 1, 0), h - 2);   // interior rows before y
    const int n_q1 = (parity & 1) == 0 ? (m + 1) / 2 : m / 2;
    const int n_q0 = m - n_q1;
    const int row_excl = n_q1 * ((w - 1) / 2) + n_q0 * ((w - 2) / 2);
    const int in_row = ((parity + y) & 1) == 1 ? (x + 1) / 2 : x / 2;
    return row_excl + in_row;
}

// Rhombus prediction of an interior pixel: floor of the mean of its four
// neighbours. The sum is >= 0, so the shift is the floor division.
template <typename T>
__device__ __forceinline__ int pee_predict(const T* __restrict__ im, int pos,
                                           int w) {
    const int s = (int)im[pos - w] + (int)im[pos + w] + (int)im[pos - 1] +
                  (int)im[pos + 1];
    return s >> 2;
}

// Rank of this thread's predicate among the block's threads of this round,
// in raster order (exclusive), and the round's total. Every thread of the
// block must call it (it holds two barriers).
__device__ __forceinline__ int pee_block_rank(bool pred, int* warp_cnt,
                                              int* round_total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned ballot = __ballot_sync(0xffffffffu, pred);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int total = 0;
#pragma unroll
    for (int k = 0; k < PEE_WARPS; ++k) {
        const int c = warp_cnt[k];
        before += k < warp ? c : 0;
        total += c;
    }
    __syncthreads();   // warp_cnt is rewritten by the next round
    *round_total = total;
    return before + __popc(ballot & ((1u << lane) - 1u));
}

// Cross-block step of the global rank: block b of the launch turns the
// per-tile counts counts[b * tiles + i] into exclusive prefixes in place and
// writes their sum to total[b]. With `want` (the embed), it also writes
// used[b] = min(want, total) and seeds nproc[b] with the saturation rule:
// n_pixels when want > total (the whole set is processed), else 0, which
// the apply launch raises to the largest embedded set rank with atomicMax.
// Launched with PEE_SCAN_THREADS threads and one block per image. Static:
// each kernel's translation unit has its own copy (no device linking).
static __global__ void pee_scan_kernel(int* __restrict__ counts, int tiles,
                                       int* __restrict__ total,
                                       const int* __restrict__ want,
                                       int* __restrict__ used,
                                       int* __restrict__ nproc,
                                       int n_pixels) {
    __shared__ int warp_sum[PEE_SCAN_THREADS / 32];
    __shared__ int carry;
    const int b = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = PEE_SCAN_THREADS / 32;
    int* c = counts + (long long)b * tiles;
    if (threadIdx.x == 0) carry = 0;
    __syncthreads();
    for (int base = 0; base < tiles; base += PEE_SCAN_THREADS) {
        const int i = base + threadIdx.x;
        const int v = i < tiles ? c[i] : 0;
        int x = v;   // inclusive scan within the warp
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, o);
            if (lane >= o) x += y;
        }
        if (lane == 31) warp_sum[warp] = x;
        __syncthreads();
        if (warp == 0) {   // inclusive scan of the warp totals
            int s = lane < nwarps ? warp_sum[lane] : 0;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, s, o);
                if (lane >= o) s += y;
            }
            if (lane < nwarps) warp_sum[lane] = s;
        }
        __syncthreads();
        const int excl = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x - v;
        if (i < tiles) c[i] = excl;
        __syncthreads();   // every thread has read carry
        if (threadIdx.x == 0) carry += warp_sum[nwarps - 1];
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        total[b] = carry;
        if (want != nullptr) {
            const int wv = want[b];
            used[b] = min(wv, carry);
            nproc[b] = wv > carry ? n_pixels : 0;
        }
    }
}

// Grid shape checks of the three-launch scan (pee_extract.cu).
static inline bool pee_shape_ok(int batch, int h, int w, int tiles) {
    if (batch < 1 || batch > 65535 || h < 1 || w < 1) return false;
    const long long n = (long long)h * w;
    if (n > 0x7fffffffLL - PEE_TILE_PX) return false;
    return tiles == (int)((n + PEE_TILE_PX - 1) / PEE_TILE_PX);
}

// ---------------------------------------------------------------------------
// Single-pass pieces (pee_embed.cu): a block owns one tile of consecutive
// raster pixels and each thread a run of them; the tile's offset into the
// image's global rank comes from a decoupled look-back over the status words
// of the tiles before it, so one launch reads the image once.
// ---------------------------------------------------------------------------

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
