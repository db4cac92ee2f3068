// Shared pieces of the PEE kernels (pee_embed.cu, pee_extract.cu).
//
// Both kernels walk each image of a (B, H, W) batch in raster tiles of
// PEE_TILE_PX pixels: block (tile, b) owns pixels [tile * PEE_TILE_PX,
// (tile + 1) * PEE_TILE_PX) of image b and visits them in PEE_ROUNDS rounds
// of PEE_THREADS consecutive pixels, so every load and store of a round is
// coalesced and raster order inside a block is (round, warp, lane).
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

// Grid shape checks shared by the two launchers.
static inline bool pee_shape_ok(int batch, int h, int w, int tiles) {
    if (batch < 1 || batch > 65535 || h < 1 || w < 1) return false;
    const long long n = (long long)h * w;
    if (n > 0x7fffffffLL - PEE_TILE_PX) return false;
    return tiles == (int)((n + PEE_TILE_PX - 1) / PEE_TILE_PX);
}
