// K1 raster_embed: multi-plane raster LSB embed + bit-packed XOR maps.
//
// Replaces (codec_tcc_tpu/ops/pallas_embed.py):
//   embed_batch / _embed_kernel + _embed_core           (pallas_call :308)
//   embed_batch_padded / _embed_kernel_padded_out        (pallas_call :248)
//   embed_batch_preplaced / _embed_preplaced_kernel      (pallas_call :835)
// and the XLA "packed" tier (preplace_packed_device + embed_batch_packed)
// fused with ops/embed.py::xor_maps_packed_batch. Those Pallas kernels run
// grid=(B, N/tile) over a batch with per-image (B, NP) plans:
// raster_embed_batch is that batch axis, one launch per batch.
//
// Function: for each plane p < s, pixel pos with rel = (pos - start_p) mod N
// below len_p gets bit p := the low bit of msg[off_p + rel] (0 past the
// message's end); planes at or past the pixel's width change nothing. With
// emit_maps, byte g of map plane p holds bit p of orig ^ stego (the stego
// narrowed to the pixel type) for pixels 8g..8g+7, MSB first (np.packbits
// order), so map planes at or past the pixel's width are zero.
//
// Bound: memory, no tensor-core work. It reads the image and the message
// bytes inside the windows once and writes the stego and s/8 map bytes per
// pixel once; at 2048x2048 uint16 and s = 5 that is 28.6 MB, about 8.5 us at
// 3.35 TB/s.
//
// Design: one thread owns a chunk of RASTER_EMBED_PIXELS consecutive
// pixels, so the maps need no exchange between threads. It reads them with
// aligned 16-byte vectors (raster_load_words: any element address) and
// keeps them packed, four uint8 or two uint16 pixels to a 32-bit word. Per
// plane it classifies the chunk from the plan, which travels by value:
// inside the window (all pixels embed, and since the window is at most N
// long nothing wraps, so their message bytes are consecutive: loaded as
// aligned vectors too and set into the plane's bit of every pixel of a word
// at once), outside it (untouched), or across its edge or the raster's end
// (pixel by pixel). The maps come from the chunk's diff, bit p of four
// pixels per instruction, packed to bytes by one multiply. The stego goes
// out as 16-byte stores; the last, partial chunk goes pixel by pixel.
//
// Batch: blockIdx.y selects the image. Its plan and cut point come from a
// table in device memory (raster_common.cuh: RasterBatchPlan), which each
// block copies into shared memory first; then the block runs the same
// chunk code on image i. Image i starts at i * N elements, so its stores
// take the widest width its alignment allows (raster_store_words). Map
// rows go to (B, max_s, N/8); rows s_i..max_s - 1 of image i are zero
// because its planes at and past s_i never change.
#include "raster_common.cuh"

#define RASTER_EMBED_PIXELS 16     // pixels per thread
// 128 rather than 256: the same occupancy (40 registers), half the tail of
// the last wave (tools/torch_pee_embed_probe.py --kernel raster_embed)
#define RASTER_EMBED_THREADS 128

// Eight 0/1 bytes (lo: pixels 0-3, hi: pixels 4-7, the first in the low
// byte) as one byte, pixel 0 in bit 7: the multiply moves byte j's bit to
// bit 63 - j and no two partial products meet.
__device__ __forceinline__ uint32_t raster_pack8(uint32_t lo, uint32_t hi) {
    const unsigned long long v = lo | ((unsigned long long)hi << 32);
    return (uint32_t)((v * 0x8040201008040201ull) >> 56);
}

// The message bit of each pixel of pixel word i, in bit 0 of its lane:
// m holds one message byte per pixel, four to a word.
template <typename T, int MW>
__device__ __forceinline__ uint32_t raster_lane_bits(const uint32_t (&m)[MW],
                                                     int i) {
    if constexpr (sizeof(T) == 1) {
        return m[i] & 0x01010101u;
    } else {
        return __byte_perm(m[i >> 1], 0u, (i & 1) ? 0x4342 : 0x4140) &
               0x00010001u;
    }
}

// NB bytes (the low ones of `word`) to dst: one store where dst is aligned
// to it, else byte by byte.
template <int NB>
__device__ __forceinline__ void raster_store_bytes(uint8_t* dst,
                                                   uint32_t word) {
    if (((uintptr_t)dst & (NB - 1)) == 0) {
        if constexpr (NB == 1) {
            *dst = (uint8_t)word;
        } else if constexpr (NB == 2) {
            *reinterpret_cast<uint16_t*>(dst) = (uint16_t)word;
        } else {
            *reinterpret_cast<uint32_t*>(dst) = word;
        }
    } else {
#pragma unroll
        for (int j = 0; j < NB; ++j) dst[j] = (uint8_t)(word >> (8 * j));
    }
}

// Chunk g of one image: embed planes 0..planes-1 of the plan and, with
// emit_maps, write map rows 0..map_rows-1. ANY_ALIGN: the stego need not be
// 16-byte aligned (images of a batch past the first).
template <typename T, bool ANY_ALIGN>
__device__ __forceinline__ void raster_embed_chunk(
    const T* __restrict__ img, const uint8_t* __restrict__ msg,
    unsigned msg_len, const RasterPlan& plan, int planes, int map_rows,
    unsigned n, int emit_maps, T* __restrict__ stego,
    uint8_t* __restrict__ maps, unsigned g) {
    constexpr int CHUNK = RASTER_EMBED_PIXELS;
    constexpr int BITS = 8 * (int)sizeof(T);
    constexpr int PPW = 4 / (int)sizeof(T);      // pixels per word
    constexpr int NW = CHUNK / PPW;              // pixel words
    constexpr int MW = CHUNK / 4;                // message words
    constexpr int MB = CHUNK / 8;                // map bytes per plane
    constexpr uint32_t LANES = sizeof(T) == 1 ? 0x01010101u : 0x00010001u;
    static_assert(CHUNK % 8 == 0 && MB <= 4, "chunks of 8, 16 or 32 pixels");

    const unsigned base = g * CHUNK;
    if (base >= n) return;
    const unsigned cnt = min(n - base, (unsigned)CHUNK);
    const bool full = cnt == CHUNK;

    uint32_t orig[NW];
    if (full) {
        raster_load_words(reinterpret_cast<const uint8_t*>(img + base), orig);
    } else {
#pragma unroll
        for (int i = 0; i < NW; ++i) orig[i] = 0u;
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
            if ((unsigned)k < cnt) {
                orig[k / PPW] |= (uint32_t)img[base + k] << (BITS * (k % PPW));
            }
        }
    }
    uint32_t v[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) v[i] = orig[i];

    for (int p = 0; p < planes; ++p) {
        const int len = plan.len[p];
        if (len <= 0) continue;
        const unsigned start = (unsigned)plan.start[p];
        const unsigned off = (unsigned)plan.off[p];
        // window offset of the chunk's first pixel, and the window's extent
        // within one pass over the raster
        const unsigned rel0 = base >= start ? base - start : base + n - start;
        const unsigned lim = min((unsigned)len, n);
        if (full && rel0 + CHUNK <= lim) {
            // inside: message bytes m0 .. m0 + CHUNK - 1
            const unsigned m0 = off + rel0;
            uint32_t m[MW];
            if (m0 + CHUNK <= msg_len) {
                raster_load_words(msg + m0, m);
            } else {
#pragma unroll
                for (int i = 0; i < MW; ++i) m[i] = 0u;
#pragma unroll
                for (int b = 0; b < CHUNK; ++b) {
                    if (m0 + b < msg_len) {
                        m[b / 4] |= (uint32_t)msg[m0 + b] << (8 * (b % 4));
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < NW; ++i) {
                v[i] = (v[i] & ~(LANES << p)) |
                       (raster_lane_bits<T>(m, i) << p);
            }
        } else if (!full || rel0 < lim || rel0 + CHUNK > n) {
            // across the window's edge or the raster's end: pixel by pixel
#pragma unroll
            for (int k = 0; k < CHUNK; ++k) {
                if ((unsigned)k >= cnt) continue;
                unsigned rel = rel0 + k;             // below 2n
                if (rel >= n) rel -= n;
                if (rel < (unsigned)len) {
                    const unsigned idx = off + rel;
                    const uint32_t bit = idx < msg_len ? msg[idx] & 1u : 0u;
                    const int sh = BITS * (k % PPW) + p;
                    v[k / PPW] = (v[k / PPW] & ~(1u << sh)) | (bit << sh);
                }
            }
        }
        // else outside the window: the plane stays as it is
    }

    if (full && ANY_ALIGN) {
        raster_store_words<NW>(reinterpret_cast<uint8_t*>(stego + base), v);
    } else if (full) {
        if constexpr (NW % 4 == 0) {
#pragma unroll
            for (int i = 0; i < NW / 4; ++i) {
                reinterpret_cast<uint4*>(stego + base)[i] =
                    make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                               v[4 * i + 3]);
            }
        } else {
#pragma unroll
            for (int i = 0; i < NW / 2; ++i) {
                reinterpret_cast<uint2*>(stego + base)[i] =
                    make_uint2(v[2 * i], v[2 * i + 1]);
            }
        }
    } else {
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
            if ((unsigned)k < cnt) {
                stego[base + k] = (T)(v[k / PPW] >> (BITS * (k % PPW)));
            }
        }
    }

    if (emit_maps) {
        uint32_t d[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) d[i] = orig[i] ^ v[i];
        const size_t row_bytes = n / 8;   // the launch requires n % 8 == 0
        uint8_t* row = maps + (size_t)g * MB;
        for (int p = 0; p < map_rows; ++p, row += row_bytes) {
            uint32_t q[MW];
#pragma unroll
            for (int i = 0; i < MW; ++i) q[i] = 0u;
            if (p < BITS) raster_plane_bytes<T, CHUNK>(d, p, q);
            uint32_t word = 0u;
#pragma unroll
            for (int j = 0; j < MB; ++j) {
                word |= raster_pack8(q[2 * j], q[2 * j + 1]) << (8 * j);
            }
            if (full) {
                raster_store_bytes<MB>(row, word);
            } else {
#pragma unroll
                for (int j = 0; j < MB; ++j) {
                    if ((unsigned)(8 * j) < cnt) {
                        row[j] = (uint8_t)(word >> (8 * j));
                    }
                }
            }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(RASTER_EMBED_THREADS)
raster_embed_kernel(const T* __restrict__ img,
                    const uint8_t* __restrict__ msg, unsigned msg_len,
                    const __grid_constant__ RasterPlan plan, int planes,
                    int s, unsigned n, int emit_maps, T* __restrict__ stego,
                    uint8_t* __restrict__ maps) {
    raster_embed_chunk<T, false>(
        img, msg, msg_len, plan, planes, s, n, emit_maps, stego, maps,
        blockIdx.x * RASTER_EMBED_THREADS + threadIdx.x);
}

// Image blockIdx.y of a batch: pixels at img + i * n, message bytes at
// msg + i * msg_len, its plan at table[i], map rows at maps + i * max_s *
// n / 8.
template <typename T>
__global__ void __launch_bounds__(RASTER_EMBED_THREADS)
raster_embed_batch_kernel(const T* __restrict__ img,
                          const uint8_t* __restrict__ msg, unsigned msg_len,
                          const RasterBatchPlan* __restrict__ table,
                          int max_s, unsigned n, int emit_maps,
                          T* __restrict__ stego, uint8_t* __restrict__ maps) {
    __shared__ RasterBatchPlan entry;
    const unsigned i = blockIdx.y;
    raster_load_entry<RasterBatchPlan, RASTER_EMBED_THREADS>(table + i,
                                                             &entry);
    const int bits = 8 * (int)sizeof(T);
    const size_t px = (size_t)i * n;
    raster_embed_chunk<T, true>(
        img + px, msg + (size_t)i * msg_len, msg_len, entry.plan,
        entry.s < bits ? entry.s : bits, max_s, n, emit_maps, stego + px,
        maps == nullptr ? nullptr : maps + (size_t)i * max_s * (n / 8),
        blockIdx.x * RASTER_EMBED_THREADS + threadIdx.x);
}

template <typename T>
static int launch_embed(const void* img, const void* msg, long long msg_len,
                        const int* starts, const int* lens, const int* offs,
                        int np, int s, long long n, int emit_maps, void* stego,
                        void* maps, void* stream) {
    if (np < 0 || np > RASTER_MAX_PLANES || s < 0 || s > np || n < 0 ||
        n > 0x7fffffffLL || msg_len < 0 || (emit_maps && n % 8) ||
        ((uintptr_t)stego & 15u) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0) return 0;
    // the kernel indexes pixels and message bytes in 32 bits
    for (int p = 0; p < s; ++p) {
        if (lens[p] > 0 && (starts[p] < 0 || starts[p] >= n || offs[p] < 0 ||
                            offs[p] + n > 0x7fffffffLL)) {
            return (int)cudaErrorInvalidValue;
        }
    }
    const RasterPlan plan = raster_make_plan(starts, lens, offs, np);
    const long long chunks = (n + RASTER_EMBED_PIXELS - 1) / RASTER_EMBED_PIXELS;
    const long long blocks =
        (chunks + RASTER_EMBED_THREADS - 1) / RASTER_EMBED_THREADS;
    const int planes = s < 8 * (int)sizeof(T) ? s : 8 * (int)sizeof(T);
    raster_embed_kernel<T><<<(unsigned)blocks, RASTER_EMBED_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const T*)img, (const uint8_t*)msg,
        (unsigned)(msg_len < 0x7fffffffLL ? msg_len : 0x7fffffffLL), plan,
        planes, s, (unsigned)n, emit_maps, (T*)stego, (uint8_t*)maps);
    return (int)cudaGetLastError();
}

// Check one image's entry of the batch table as launch_embed checks a plan.
static bool raster_batch_entry_ok(const RasterBatchPlan& e, int max_s,
                                  long long n) {
    if (e.s < 0 || e.s > max_s) return false;
    for (int p = 0; p < e.s; ++p) {
        const int len = e.plan.len[p];
        if (len > 0 && (e.plan.start[p] < 0 || e.plan.start[p] >= n ||
                        e.plan.off[p] < 0 ||
                        e.plan.off[p] + n > 0x7fffffffLL)) {
            return false;
        }
    }
    return true;
}

// table_host and table_dev hold the same `batch` entries: the host copy is
// checked here, the device copy is what the kernel reads.
template <typename T>
static int launch_embed_batch(const void* img, const void* msg,
                              long long msg_len, const void* table_host,
                              const void* table_dev, int batch, int max_s,
                              long long n, int emit_maps, void* stego,
                              void* maps, void* stream) {
    if (batch < 1 || batch > 65535 || max_s < 0 ||
        max_s > RASTER_MAX_PLANES || n < 0 || n > 0x7fffffffLL ||
        msg_len < 0 || msg_len > 0x7fffffffLL || (emit_maps && n % 8) ||
        (emit_maps && max_s > 0 && maps == nullptr) ||
        ((uintptr_t)table_dev & 3u) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const RasterBatchPlan* entries =
        static_cast<const RasterBatchPlan*>(table_host);
    for (int i = 0; i < batch; ++i) {
        if (!raster_batch_entry_ok(entries[i], max_s, n)) {
            return (int)cudaErrorInvalidValue;
        }
    }
    if (n == 0) return 0;
    const long long chunks = (n + RASTER_EMBED_PIXELS - 1) / RASTER_EMBED_PIXELS;
    const long long blocks =
        (chunks + RASTER_EMBED_THREADS - 1) / RASTER_EMBED_THREADS;
    const dim3 grid((unsigned)blocks, (unsigned)batch);
    raster_embed_batch_kernel<T><<<grid, RASTER_EMBED_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        (const T*)img, (const uint8_t*)msg, (unsigned)msg_len,
        static_cast<const RasterBatchPlan*>(table_dev), max_s, (unsigned)n,
        emit_maps, (T*)stego, emit_maps ? (uint8_t*)maps : nullptr);
    return (int)cudaGetLastError();
}

extern "C" {

int raster_embed_u8(const void* img, const void* msg, long long msg_len,
                    const int* starts, const int* lens, const int* offs,
                    int np, int s, long long n, int emit_maps, void* stego,
                    void* maps, void* stream) {
    return launch_embed<uint8_t>(img, msg, msg_len, starts, lens, offs, np, s,
                                 n, emit_maps, stego, maps, stream);
}

int raster_embed_u16(const void* img, const void* msg, long long msg_len,
                     const int* starts, const int* lens, const int* offs,
                     int np, int s, long long n, int emit_maps, void* stego,
                     void* maps, void* stream) {
    return launch_embed<uint16_t>(img, msg, msg_len, starts, lens, offs, np,
                                  s, n, emit_maps, stego, maps, stream);
}

int raster_embed_batch_u8(const void* img, const void* msg, long long msg_len,
                          const void* table_host, const void* table_dev,
                          int batch, int max_s, long long n, int emit_maps,
                          void* stego, void* maps, void* stream) {
    return launch_embed_batch<uint8_t>(img, msg, msg_len, table_host,
                                       table_dev, batch, max_s, n, emit_maps,
                                       stego, maps, stream);
}

int raster_embed_batch_u16(const void* img, const void* msg,
                           long long msg_len, const void* table_host,
                           const void* table_dev, int batch, int max_s,
                           long long n, int emit_maps, void* stego, void* maps,
                           void* stream) {
    return launch_embed_batch<uint16_t>(img, msg, msg_len, table_host,
                                        table_dev, batch, max_s, n, emit_maps,
                                        stego, maps, stream);
}

// Message of a CUDA error code, for the wrappers of every kernel.
const char* codec_kernels_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
