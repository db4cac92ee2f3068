// K2 raster_extract: payload bits in message order, straight from the stego.
//
// Replaces (codec_tcc_tpu/ops/pallas_embed.py):
//   extract_aligned_batch / _extract_kernel              (pallas_call :386)
//   extract_aligned_batch_padded / _extract_padded_kernel (pallas_call :478)
//   extract_raster_batch / _extract_raster_kernel         (pallas_call :897)
// and the assembly that followed them on the TPU (ops/embed.py::
// assemble_message_device / assemble_raster_device, the XLA packed tier's
// extract_packed_batch + unpack_rows_device). Those Pallas kernels run
// grid=(B, N/tile) over a batch with per-image (B, NP) plans:
// raster_extract_batch is that batch axis, one launch per batch.
//
// Function: out[j] comes from the HIGHEST plane p whose window covers j
// (0 <= j - off_p < len_p, len_p > 0): (stego[(start_p + j - off_p) mod N]
// >> p) & 1 when p < s and j - off_p < N, else 0. Uncovered bits are 0.
// This equals applying planes in ascending order with later ones
// overwriting, which is what codec_tcc_tpu/ops/host_extract.py::
// extract_raster_host does (including aliased windows and past-s planes
// that write zeros).
//
// Bound: memory, no tensor-core work. It reads only the pixels the windows
// cover and writes out_len bytes; at 2048x2048 uint16 and s = 5 that is
// 17.6 MB, about 5 us at 3.35 TB/s.
//
// Design: the host resolves the plan into message-order segments
// (RasterSegments, raster_common.cuh; ops/raster_kernels.py::
// extract_segments), in each of which every bit is one plane of
// consecutive pixels, or 0. The table travels as a __grid_constant__
// launch parameter. Each thread writes RASTER_EXTRACT_BYTES consecutive
// output bytes with vector stores. Where its chunk lies inside one segment
// (all but a few chunks), it reads the chunk's consecutive pixels with
// aligned 16-byte loads, shifts them into place and takes the plane's bit
// of four pixels per instruction; a chunk that straddles a segment
// boundary, or holds the tail, goes byte by byte. The planes re-read the
// same pixels, but the stego fits in the 50 MB L2.
//
// Batch: blockIdx.y selects the image, whose segment table is entry i of a
// table in device memory (one RasterSegments per image, 788 bytes), which
// each block copies into shared memory before the same chunk code runs.
// Output row i starts at i * out_len bytes, so its stores take the widest
// width its alignment allows (raster_store_words).
#include "raster_common.cuh"

#define RASTER_EXTRACT_BYTES 16      // output bytes (bits) per thread
#define RASTER_EXTRACT_THREADS 256

// The segment that holds message bit j: begin[k] <= j < begin[k + 1].
__device__ __forceinline__ int raster_find_segment(const RasterSegments& seg,
                                                   unsigned j) {
    int lo = 0, hi = seg.count;
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if ((unsigned)seg.begin[mid] <= j) {
            lo = mid;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// Bit p of the CHUNK consecutive pixels at px, one byte each, four to a
// word.
template <typename T, int CHUNK>
__device__ __forceinline__ void raster_bits_of_run(const T* px, int p,
                                                   uint32_t (&o)[CHUNK / 4]) {
    uint32_t w[CHUNK * (int)sizeof(T) / 4];
    raster_load_words(reinterpret_cast<const uint8_t*>(px), w);
    raster_plane_bytes<T, CHUNK>(w, p, o);
}

// The chunk's bytes: vector stores when all CHUNK are in range, else the
// first `rem` one by one. ANY_ALIGN: dst need not be 16-byte aligned.
template <int CHUNK, bool ANY_ALIGN>
__device__ __forceinline__ void raster_store_chunk(
    uint8_t* dst, const uint32_t (&o)[CHUNK / 4], unsigned rem) {
    if (ANY_ALIGN && rem >= (unsigned)CHUNK) {
        raster_store_words<CHUNK / 4>(dst, o);
    } else if (rem >= (unsigned)CHUNK) {
        if constexpr (CHUNK % 16 == 0) {
#pragma unroll
            for (int i = 0; i < CHUNK / 16; ++i) {
                reinterpret_cast<uint4*>(dst)[i] = make_uint4(
                    o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
            }
        } else {
#pragma unroll
            for (int i = 0; i < CHUNK / 8; ++i) {
                reinterpret_cast<uint2*>(dst)[i] =
                    make_uint2(o[2 * i], o[2 * i + 1]);
            }
        }
    } else {
#pragma unroll
        for (int b = 0; b < CHUNK; ++b) {
            if ((unsigned)b < rem) dst[b] = (uint8_t)(o[b / 4] >> 8 * (b % 4));
        }
    }
}

// Chunk t of one image's message order: bits j0 = t * CHUNK onwards.
template <typename T, bool ANY_ALIGN>
__device__ __forceinline__ void raster_extract_chunk(
    const T* __restrict__ stego, const RasterSegments& seg, unsigned out_len,
    uint8_t* __restrict__ out, unsigned t) {
    constexpr int CHUNK = RASTER_EXTRACT_BYTES;
    static_assert(CHUNK % 8 == 0, "chunks are stored as 8/16-byte vectors");
    const unsigned j0 = t * (unsigned)CHUNK;
    if (j0 >= out_len) return;
    int k = raster_find_segment(seg, j0);
    uint32_t o[CHUNK / 4];
#pragma unroll
    for (int i = 0; i < CHUNK / 4; ++i) o[i] = 0u;
    if (j0 + CHUNK <= (unsigned)seg.begin[k + 1]) {
        // the chunk lies inside segment k: one plane of consecutive pixels
        const int p = seg.plane[k];
        if (p >= 0) {
            raster_bits_of_run<T, CHUNK>(
                stego + seg.pos[k] + (j0 - seg.begin[k]), p, o);
        }
    } else {
        // it straddles a segment boundary or holds the tail: byte by byte
#pragma unroll
        for (int b = 0; b < CHUNK; ++b) {
            const unsigned j = j0 + b;
            if (j < out_len) {
                while (j >= (unsigned)seg.begin[k + 1]) ++k;
                const int p = seg.plane[k];
                if (p >= 0) {
                    const uint32_t x = stego[seg.pos[k] + (j - seg.begin[k])];
                    o[b / 4] |= ((x >> p) & 1u) << (8 * (b % 4));
                }
            }
        }
    }
    raster_store_chunk<CHUNK, ANY_ALIGN>(out + j0, o, out_len - j0);
}

template <typename T>
__global__ void __launch_bounds__(RASTER_EXTRACT_THREADS)
raster_extract_kernel(const T* __restrict__ stego,
                      const __grid_constant__ RasterSegments seg,
                      unsigned out_len, uint8_t* __restrict__ out) {
    raster_extract_chunk<T, false>(
        stego, seg, out_len, out,
        blockIdx.x * RASTER_EXTRACT_THREADS + threadIdx.x);
}

// Image blockIdx.y of a batch: pixels at stego + i * n, its segments at
// table[i], its bits at out + i * out_len.
template <typename T>
__global__ void __launch_bounds__(RASTER_EXTRACT_THREADS)
raster_extract_batch_kernel(const T* __restrict__ stego,
                            const RasterSegments* __restrict__ table,
                            unsigned n, unsigned out_len,
                            uint8_t* __restrict__ out) {
    __shared__ RasterSegments seg;
    const unsigned i = blockIdx.y;
    raster_load_entry<RasterSegments, RASTER_EXTRACT_THREADS>(table + i, &seg);
    raster_extract_chunk<T, true>(
        stego + (size_t)i * n, seg, out_len, out + (size_t)i * out_len,
        blockIdx.x * RASTER_EXTRACT_THREADS + threadIdx.x);
}

// Check a segment table, so that no segment reads outside the image or
// past the dtype's bits.
template <typename T>
static bool raster_segments_ok(const RasterSegments& seg, long long n,
                               long long out_len) {
    const int count = seg.count;
    if (count < 1 || count > RASTER_MAX_SEGMENTS || seg.begin[0] != 0 ||
        seg.begin[count] != out_len) {
        return false;
    }
    for (int k = 0; k < count; ++k) {
        const long long len = (long long)seg.begin[k + 1] - seg.begin[k];
        const int plane = seg.plane[k];
        if (len <= 0 || plane < -1 || plane >= 8 * (int)sizeof(T) ||
            (plane >= 0 && (seg.pos[k] < 0 || seg.pos[k] + len > n))) {
            return false;
        }
    }
    return true;
}

// Copy the host arrays into a segment table and check it.
template <typename T>
static bool raster_make_segments(const int* begin, const int* pos,
                                 const int* plane, int count, long long n,
                                 long long out_len, RasterSegments* seg) {
    if (count < 1 || count > RASTER_MAX_SEGMENTS) return false;
    seg->count = count;
    for (int k = 0; k <= RASTER_MAX_SEGMENTS; ++k) {
        seg->begin[k] = k <= count ? begin[k] : (int)out_len;
    }
    for (int k = 0; k < RASTER_MAX_SEGMENTS; ++k) {
        seg->pos[k] = k < count ? pos[k] : 0;
        seg->plane[k] = k < count ? plane[k] : -1;
    }
    return raster_segments_ok<T>(*seg, n, out_len);
}

template <typename T>
static int launch_extract(const void* stego, const int* begin, const int* pos,
                          const int* plane, int count, long long n,
                          long long out_len, void* out, void* stream) {
    RasterSegments seg;
    if (n <= 0 || n > 0x7fffffffLL || out_len < 1 || out_len > 0x7fffffffLL ||
        ((uintptr_t)out & 15u) != 0 ||
        !raster_make_segments<T>(begin, pos, plane, count, n, out_len, &seg)) {
        return (int)cudaErrorInvalidValue;
    }
    const long long chunks = (out_len + RASTER_EXTRACT_BYTES - 1) /
                             RASTER_EXTRACT_BYTES;
    const long long blocks = (chunks + RASTER_EXTRACT_THREADS - 1) /
                             RASTER_EXTRACT_THREADS;
    raster_extract_kernel<T><<<(unsigned)blocks, RASTER_EXTRACT_THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const T*)stego, seg, (unsigned)out_len, (uint8_t*)out);
    return (int)cudaGetLastError();
}

// table_host and table_dev hold the same `batch` segment tables: the host
// copy is checked here, the device copy is what the kernel reads.
template <typename T>
static int launch_extract_batch(const void* stego, const void* table_host,
                                const void* table_dev, int batch, long long n,
                                long long out_len, void* out, void* stream) {
    if (batch < 1 || batch > 65535 || n <= 0 || n > 0x7fffffffLL ||
        out_len < 1 || out_len > 0x7fffffffLL ||
        ((uintptr_t)table_dev & 3u) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const RasterSegments* tables =
        static_cast<const RasterSegments*>(table_host);
    for (int i = 0; i < batch; ++i) {
        if (!raster_segments_ok<T>(tables[i], n, out_len)) {
            return (int)cudaErrorInvalidValue;
        }
    }
    const long long chunks = (out_len + RASTER_EXTRACT_BYTES - 1) /
                             RASTER_EXTRACT_BYTES;
    const long long blocks = (chunks + RASTER_EXTRACT_THREADS - 1) /
                             RASTER_EXTRACT_THREADS;
    const dim3 grid((unsigned)blocks, (unsigned)batch);
    raster_extract_batch_kernel<T><<<grid, RASTER_EXTRACT_THREADS, 0,
                                     (cudaStream_t)stream>>>(
        (const T*)stego, static_cast<const RasterSegments*>(table_dev),
        (unsigned)n, (unsigned)out_len, (uint8_t*)out);
    return (int)cudaGetLastError();
}

extern "C" {

int raster_extract_u8(const void* stego, const int* begin, const int* pos,
                      const int* plane, int count, long long n,
                      long long out_len, void* out, void* stream) {
    return launch_extract<uint8_t>(stego, begin, pos, plane, count, n,
                                   out_len, out, stream);
}

int raster_extract_u16(const void* stego, const int* begin, const int* pos,
                       const int* plane, int count, long long n,
                       long long out_len, void* out, void* stream) {
    return launch_extract<uint16_t>(stego, begin, pos, plane, count, n,
                                    out_len, out, stream);
}

int raster_extract_batch_u8(const void* stego, const void* table_host,
                            const void* table_dev, int batch, long long n,
                            long long out_len, void* out, void* stream) {
    return launch_extract_batch<uint8_t>(stego, table_host, table_dev, batch,
                                         n, out_len, out, stream);
}

int raster_extract_batch_u16(const void* stego, const void* table_host,
                             const void* table_dev, int batch, long long n,
                             long long out_len, void* out, void* stream) {
    return launch_extract_batch<uint16_t>(stego, table_host, table_dev,
                                          batch, n, out_len, out, stream);
}

}  // extern "C"
