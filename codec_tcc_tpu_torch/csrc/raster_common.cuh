// Shared plan types of the raster kernels: K1 raster_embed.cu takes a
// RasterPlan (the plane plan as it is), K2 raster_extract.cu a
// RasterSegments (the same plan resolved on the host into message order).
//
// Both travel to the kernel by value as a launch parameter (192 and 788
// bytes), so no device buffer holds them and no copy precedes the launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RASTER_MAX_PLANES 16
#define RASTER_THREADS 256
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
