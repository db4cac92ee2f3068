// K1 raster_embed: multi-plane raster LSB embed + bit-packed XOR maps.
//
// Replaces (codec_tcc_tpu/ops/pallas_embed.py):
//   embed_batch / _embed_kernel + _embed_core           (pallas_call :308)
//   embed_batch_padded / _embed_kernel_padded_out        (pallas_call :248)
//   embed_batch_preplaced / _embed_preplaced_kernel      (pallas_call :835)
// and the XLA "packed" tier (preplace_packed_device + embed_batch_packed)
// fused with ops/embed.py::xor_maps_packed_batch.
//
// Function: for each plane p < s, pixel pos with rel = (pos - start_p) mod N
// below len_p gets bit p := msg[off_p + rel] (0 past the message's end).
// With emit_maps, byte g of map plane p holds bit p of orig ^ stego for
// pixels 8g..8g+7, MSB first (np.packbits order).
//
// Bound: memory and launch latency, no tensor-core work. Per pixel it reads
// the image word once and writes the stego word and s/8 map bytes once; the
// message is read only inside the windows, in raster order.
//
// Design: one thread owns 8 consecutive pixels, so the maps need no
// cross-thread exchange: the thread embeds its 8 pixels in registers and
// packs each map byte itself. The TPU kernels' DMA windows, in-register
// rotations and padded layouts are gone: the message fetch is a plain
// indexed load, and the plan is a by-value launch parameter.
#include "raster_common.cuh"

template <typename T>
__global__ void raster_embed_kernel(const T* __restrict__ img,
                                    const uint8_t* __restrict__ msg,
                                    long long msg_len, RasterPlan plan,
                                    int active_planes, int s, long long n,
                                    int emit_maps, T* __restrict__ stego,
                                    uint8_t* __restrict__ maps) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long base = g * 8;
    if (base >= n) return;
    const int cnt = (n - base) < 8 ? (int)(n - base) : 8;

    uint32_t orig[8];
    uint32_t v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        orig[k] = k < cnt ? (uint32_t)img[base + k] : 0u;
        v[k] = orig[k];
    }
    for (int p = 0; p < active_planes; ++p) {
        const long long len = plan.len[p];
        if (len <= 0) continue;
        const long long start = plan.start[p];
        const long long off = plan.off[p];
        const uint32_t keep = ~(1u << p);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            long long rel = base + k - start;
            if (rel < 0) rel += n;
            if (k < cnt && rel < len) {
                const long long idx = off + rel;
                const uint32_t bit = idx < msg_len ? (uint32_t)msg[idx] : 0u;
                v[k] = (v[k] & keep) | (bit << p);
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        if (k < cnt) stego[base + k] = (T)v[k];
    }
    if (emit_maps) {
        const long long nbytes = n >> 3;   // the wrapper requires n % 8 == 0
        for (int p = 0; p < s; ++p) {
            uint32_t byte = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                byte |= (((orig[k] ^ v[k]) >> p) & 1u) << (7 - k);
            }
            maps[(long long)p * nbytes + g] = (uint8_t)byte;
        }
    }
}

template <typename T>
static int launch_embed(const void* img, const void* msg, long long msg_len,
                        const int* starts, const int* lens, const int* offs,
                        int np, int s, long long n, int emit_maps, void* stego,
                        void* maps, void* stream) {
    if (np < 0 || np > RASTER_MAX_PLANES || s < 0 || s > np || n < 0) {
        return (int)cudaErrorInvalidValue;
    }
    const RasterPlan plan = raster_make_plan(starts, lens, offs, np);
    const long long groups = (n + 7) / 8;
    if (groups == 0) return 0;
    const long long blocks = (groups + RASTER_THREADS - 1) / RASTER_THREADS;
    raster_embed_kernel<T><<<(unsigned)blocks, RASTER_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const T*)img, (const uint8_t*)msg, msg_len, plan, s, s, n, emit_maps,
        (T*)stego, (uint8_t*)maps);
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

// Message of a CUDA error code, for the wrappers of every kernel.
const char* codec_kernels_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
