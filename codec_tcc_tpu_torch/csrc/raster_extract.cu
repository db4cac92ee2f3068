// K2 raster_extract: payload bits in message order, straight from the stego.
//
// Replaces (codec_tcc_tpu/ops/pallas_embed.py):
//   extract_aligned_batch / _extract_kernel              (pallas_call :386)
//   extract_aligned_batch_padded / _extract_padded_kernel (pallas_call :478)
//   extract_raster_batch / _extract_raster_kernel         (pallas_call :897)
// and the assembly that followed them on the TPU (ops/embed.py::
// assemble_message_device / assemble_raster_device, the XLA packed tier's
// extract_packed_batch + unpack_rows_device).
//
// Function: out[j] comes from the HIGHEST plane p whose window covers j
// (0 <= j - off_p < len_p, len_p > 0): (stego[(start_p + j - off_p) mod N]
// >> p) & 1 when p < s and j - off_p < N, else 0. Uncovered bits are 0.
// Walking planes from high to low and stopping at the first cover equals
// applying planes in ascending order with later ones overwriting, which is
// what codec_tcc_tpu/ops/host_extract.py::extract_raster_host does
// (including aliased windows and past-s planes that write zeros).
//
// Bound: memory and launch latency, no tensor-core work. It reads only the
// out_len payload pixels (not the whole image) and writes out_len bytes.
//
// Design: one thread per output bit; neighbouring threads read neighbouring
// stego words inside a window, so loads coalesce. No (NP, N) intermediate
// and no host assembly: the output is already in message order.
#include "raster_common.cuh"

template <typename T>
__global__ void raster_extract_kernel(const T* __restrict__ stego,
                                      RasterPlan plan, int np, int s,
                                      long long n, long long out_len,
                                      uint8_t* __restrict__ out) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= out_len) return;
    uint8_t bit = 0;
    for (int p = np - 1; p >= 0; --p) {
        const long long len = plan.len[p];
        if (len <= 0) continue;
        const long long rel = j - (long long)plan.off[p];
        if (rel < 0 || rel >= len) continue;
        if (p < s && rel < n) {
            long long pos = (long long)plan.start[p] + rel;   // start < n
            if (pos >= n) pos -= n;
            bit = (uint8_t)(((uint32_t)stego[pos] >> p) & 1u);
        }
        break;
    }
    out[j] = bit;
}

template <typename T>
static int launch_extract(const void* stego, const int* starts,
                          const int* lens, const int* offs, int np, int s,
                          long long n, long long out_len, void* out,
                          void* stream) {
    if (np < 0 || np > RASTER_MAX_PLANES || s < 0 || s > np || n <= 0 ||
        out_len < 0) {
        return (int)cudaErrorInvalidValue;
    }
    const RasterPlan plan = raster_make_plan(starts, lens, offs, np);
    if (out_len == 0) return 0;
    const long long blocks = (out_len + RASTER_THREADS - 1) / RASTER_THREADS;
    raster_extract_kernel<T><<<(unsigned)blocks, RASTER_THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const T*)stego, plan, np, s, n, out_len, (uint8_t*)out);
    return (int)cudaGetLastError();
}

extern "C" {

int raster_extract_u8(const void* stego, const int* starts, const int* lens,
                      const int* offs, int np, int s, long long n,
                      long long out_len, void* out, void* stream) {
    return launch_extract<uint8_t>(stego, starts, lens, offs, np, s, n,
                                   out_len, out, stream);
}

int raster_extract_u16(const void* stego, const int* starts, const int* lens,
                       const int* offs, int np, int s, long long n,
                       long long out_len, void* out, void* stream) {
    return launch_extract<uint16_t>(stego, starts, lens, offs, np, s, n,
                                    out_len, out, stream);
}

}  // extern "C"
