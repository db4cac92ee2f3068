// Shared plan type of the raster kernels (raster_embed.cu, raster_extract.cu).
//
// A plane plan is at most RASTER_MAX_PLANES (start, length, message offset)
// triples. It travels to the kernel by value as a launch parameter (192
// bytes), so no device buffer holds it and no copy precedes the launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RASTER_MAX_PLANES 16
#define RASTER_THREADS 256

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
