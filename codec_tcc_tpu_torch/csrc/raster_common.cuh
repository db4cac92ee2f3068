// Shared plan types and helpers of the raster kernels: K1 raster_embed.cu
// takes a RasterPlan (the plane plan as it is), K2 raster_extract.cu a
// RasterSegments (the same plan resolved on the host into message order).
//
// For one image both travel to the kernel by value as a launch parameter
// (192 and 788 bytes), so no device buffer holds them and no copy precedes
// the launch. The batch kernels take one per image, which the 32 KB of
// launch parameters cannot hold for a large batch (64 segment tables are
// 50 KB): they read a table of RasterBatchPlan or RasterSegments entries
// from device memory, which the wrapper uploads once per batch, and each
// block copies its image's entry into shared memory. Both kernels read
// runs of 16 consecutive pixels (K1 also 16 consecutive message bytes)
// with raster_load_words and take one plane's bit of four pixels per
// instruction with raster_plane_bytes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RASTER_MAX_PLANES 16
// Each plane cuts message order at most four times (its window's start and
// end, its wrap past the raster end, and N bits past its start, where a
// window longer than N turns to zeros), so a resolved plan has at most
// 4 * 16 + 1 segments.
#define RASTER_MAX_SEGMENTS (4 * RASTER_MAX_PLANES + 1)

struct RasterPlan {
    int start[RASTER_MAX_PLANES];   // raster start of plane p, in [0, n)
    int len[RASTER_MAX_PLANES];     // window length of plane p, >= 0
    int off[RASTER_MAX_PLANES];     // message offset of plane p, >= 0
};

// One image's entry in K1's batch table: its plane plan and cut point, 49
// int32 words (ops/raster_kernels.py builds it in this order).
struct RasterBatchPlan {
    RasterPlan plan;
    int s;                          // planes p < s embed
};

// Copy the host arrays (np <= RASTER_MAX_PLANES entries) into a plan.
static inline RasterPlan raster_make_plan(const int* starts, const int* lens,
                                          const int* offs, int np) {
    RasterPlan plan;
    for (int p = 0; p < RASTER_MAX_PLANES; ++p) {
        plan.start[p] = p < np ? starts[p] : 0;
        plan.len[p] = p < np ? lens[p] : 0;
        plan.off[p] = p < np ? offs[p] : 0;
    }
    return plan;
}

// Message order [0, out_len) cut into `count` segments: segment k holds
// bits begin[k] <= j < begin[k + 1] (begin[0] = 0, begin[count] = out_len),
// and bit j is bit plane[k] of pixel pos[k] + (j - begin[k]), which stays
// below n (a window that wraps is two segments), or 0 where plane[k] = -1.
// ops/raster_kernels.py::extract_segments resolves it from a plane plan.
struct RasterSegments {
    int count;
    int begin[RASTER_MAX_SEGMENTS + 1];
    int pos[RASTER_MAX_SEGMENTS];
    int plane[RASTER_MAX_SEGMENTS];
};

// Copy one table entry of type E into shared memory, word by word, with
// the block's NT threads; the block waits until it is there.
template <typename E, int NT>
__device__ __forceinline__ void raster_load_entry(const E* __restrict__ src,
                                                  E* dst) {
    static_assert(sizeof(E) % 4 == 0, "entries are int32 words");
    const int* s = reinterpret_cast<const int*>(src);
    int* d = reinterpret_cast<int*>(dst);
    for (int k = threadIdx.x; k < (int)(sizeof(E) / 4); k += NT) d[k] = s[k];
    __syncthreads();
}

// NW 32-bit words to `dst` (any byte address): 16-byte stores where it is
// 16-byte aligned, else the widest that its alignment allows. A batch
// puts image i at i * N elements, which need not be a multiple of 16 bytes.
template <int NW>
__device__ __forceinline__ void raster_store_words(uint8_t* dst,
                                                   const uint32_t (&w)[NW]) {
    const unsigned a = (unsigned)(uintptr_t)dst;
    if (NW % 4 == 0 && (a & 15u) == 0) {
#pragma unroll
        for (int i = 0; i < NW / 4; ++i) {
            reinterpret_cast<uint4*>(dst)[i] =
                make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
        }
    } else if ((a & 3u) == 0) {
#pragma unroll
        for (int i = 0; i < NW; ++i) reinterpret_cast<uint32_t*>(dst)[i] = w[i];
    } else if ((a & 1u) == 0) {
#pragma unroll
        for (int i = 0; i < NW; ++i) {
            reinterpret_cast<uint16_t*>(dst)[2 * i] = (uint16_t)w[i];
            reinterpret_cast<uint16_t*>(dst)[2 * i + 1] = (uint16_t)(w[i] >> 16);
        }
    } else {
#pragma unroll
        for (int i = 0; i < 4 * NW; ++i) dst[i] = (uint8_t)(w[i / 4] >> 8 * (i % 4));
    }
}

// The NW 32-bit words that start at byte address `a` (any alignment): the
// aligned 16-byte vectors that hold one of their bytes (and no other, so no
// load leaves the 16-byte blocks of the pixels asked for), shifted down by
// whole words and then by the bytes left.
template <int NW>
__device__ __forceinline__ void raster_load_words(const uint8_t* a,
                                                  uint32_t (&w)[NW]) {
    constexpr int NV = (NW + 3) / 4 + 1;
    const int r = (int)((uintptr_t)a & 15u);
    const uint4* v = reinterpret_cast<const uint4*>(a - r);
    uint32_t raw[4 * NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (16 * i < r + 4 * NW) x = v[i];
        raw[4 * i] = x.x;
        raw[4 * i + 1] = x.y;
        raw[4 * i + 2] = x.z;
        raw[4 * i + 3] = x.w;
    }
    if (r & 4) {
#pragma unroll
        for (int i = 0; i + 1 < 4 * NV; ++i) raw[i] = raw[i + 1];
    }
    if (r & 8) {
#pragma unroll
        for (int i = 0; i + 2 < 4 * NV; ++i) raw[i] = raw[i + 2];
    }
    const unsigned sh = 8u * (unsigned)(r & 3);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
        w[i] = __funnelshift_r(raw[i], raw[i + 1], sh);
    }
}

// Bit p of CHUNK consecutive pixels held in the words w (a uint8 word holds
// four pixels, a uint16 word two, the first in the low bits), one byte each,
// four to a word. p must be below the pixel's width.
template <typename T, int CHUNK>
__device__ __forceinline__ void raster_plane_bytes(
    const uint32_t (&w)[CHUNK * (int)sizeof(T) / 4], int p,
    uint32_t (&o)[CHUNK / 4]) {
#pragma unroll
    for (int i = 0; i < CHUNK / 4; ++i) {
        if constexpr (sizeof(T) == 1) {
            o[i] = (w[i] >> p) & 0x01010101u;
        } else {
            o[i] = __byte_perm((w[2 * i] >> p) & 0x00010001u,
                               (w[2 * i + 1] >> p) & 0x00010001u, 0x6420);
        }
    }
}
