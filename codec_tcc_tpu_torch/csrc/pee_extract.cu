// K4 pee_extract: inverts one prediction-error-expansion pass over a batch.
//
// Replaces (codec_tcc_tpu/ops/pallas_pee.py):
//   _extract_call / _extract_kernel   (pallas_call :781), reached through
//   extract_pass_batch :949 and extract_both_passes_batch :1049, and the
//   host join of its per-tile bit segments (collect_bits :1072).
// Its plain torch version is codec_tcc_tpu_torch/ops/pee.py `extract_pass`
// (the XLA formulas of codec_tcc_tpu/ops/pee.py :305).
//
// Function, per image b: the processed pixels are the in-set pixels of
// colour `parity` with set rank <= nproc[b] and a clear overflow flag; with
// pred from the (already restored) other colour and e2 = x - pred, a
// processed pixel is "expanded" when -2t <= e2 < 2t. An expanded pixel
// carries bit e2 & 1 (floor-mod 2) and restores to pred + ((e2 - bit) >> 1)
// (arithmetic shift); a processed shifted one restores to pred + e2 -+ t;
// the rest pass through. The bits go to bits[b, r] in raster order (r = the
// pixel's rank among the expanded ones), only where r < out_len: a forged
// container may hold more expanded pixels than its payload. nbits[b] is the
// count of expanded pixels. The wrapper zero-fills the bit rows.
//
// Bound: bytes. Per pixel it must read the stego and the overflow byte once
// and write the restored pixel once, plus one byte per extracted bit. At
// 2048x2048 u16 that is ~21 MB plus the bits, ~6.5 us at 3.35 TB/s.
//
// Design: the same three launches as K3 (pee_embed.cu): (a) count the
// expanded pixels per tile, (b) scan the counts per image (which also gives
// nbits), (c) recompute, rank with ballot + popcount, restore and write each
// bit at its global rank. The TPU kernel's compress network, transposed
// one-hot MXU scatter and per-tile segments joined on the host are gone:
// the global rank is known in the kernel, so each bit is stored straight
// to its place in the message, and consecutive expanded pixels store to
// consecutive bytes. Out of place: (c) reads only the input stego.
#include "pee_common.cuh"

struct PeeExtractPixel {
    int x = 0, pred = 0, e2 = 0;
    bool processed = false, expanded = false;
};

template <typename T>
__device__ __forceinline__ PeeExtractPixel pee_extract_classify(
    const T* __restrict__ im, const uint8_t* __restrict__ ov, int pos, int h,
    int w, int parity, int t, int np) {
    PeeExtractPixel p;
    const int y = pos / w;
    const int xc = pos - y * w;
    p.x = (int)im[pos];
    if (!pee_in_set(y, xc, h, w, parity)) return p;
    p.processed =
        pee_set_rank(y, xc, h, w, parity) <= np && ov[pos] == 0;
    if (!p.processed) return p;
    p.pred = pee_predict(im, pos, w);
    p.e2 = p.x - p.pred;
    p.expanded = p.e2 >= -2 * t && p.e2 < 2 * t;
    return p;
}

template <typename T>
__global__ void __launch_bounds__(PEE_THREADS)
pee_extract_count_kernel(const T* __restrict__ stego,
                         const uint8_t* __restrict__ over,
                         const int* __restrict__ nproc, int h, int w,
                         int parity, int t, int tiles,
                         int* __restrict__ counts) {
    const int b = blockIdx.y;
    const int n = h * w;
    const long long img_off = (long long)b * n;
    const int np = nproc[b];
    const int tile0 = blockIdx.x * PEE_TILE_PX;
    int cnt = 0;
    for (int r = 0; r < PEE_ROUNDS; ++r) {
        const int pos = tile0 + r * PEE_THREADS + threadIdx.x;
        bool expanded = false;
        if (pos < n) {
            expanded = pee_extract_classify(stego + img_off, over + img_off,
                                            pos, h, w, parity, t, np)
                           .expanded;
        }
        cnt += __syncthreads_count(expanded);
    }
    if (threadIdx.x == 0) counts[(long long)b * tiles + blockIdx.x] = cnt;
}

template <typename T>
__global__ void __launch_bounds__(PEE_THREADS)
pee_extract_apply_kernel(const T* __restrict__ stego,
                         const uint8_t* __restrict__ over,
                         const int* __restrict__ nproc, int h, int w,
                         int parity, int t, int tiles,
                         const int* __restrict__ offsets, long long out_len,
                         T* __restrict__ restored,
                         uint8_t* __restrict__ bits) {
    __shared__ int warp_cnt[PEE_WARPS];
    const int b = blockIdx.y;
    const int n = h * w;
    const long long img_off = (long long)b * n;
    const int np = nproc[b];
    uint8_t* out_bits = bits + b * out_len;
    const int tile0 = blockIdx.x * PEE_TILE_PX;
    int carry = offsets[(long long)b * tiles + blockIdx.x];
    for (int r = 0; r < PEE_ROUNDS; ++r) {
        const int pos = tile0 + r * PEE_THREADS + threadIdx.x;
        const bool valid = pos < n;
        PeeExtractPixel p;
        if (valid) {
            p = pee_extract_classify(stego + img_off, over + img_off, pos, h,
                                     w, parity, t, np);
        }
        int round_total;
        const int rank = carry + pee_block_rank(p.expanded, warp_cnt,
                                                &round_total);
        carry += round_total;
        if (!valid) continue;
        int out = p.x;
        if (p.processed) {
            const int bit = p.e2 & 1;   // floor-mod 2 in two's complement
            int e;
            if (p.expanded) {
                e = (p.e2 - bit) >> 1;   // arithmetic shift of a signed int
                if (rank < out_len) out_bits[rank] = (uint8_t)bit;
            } else {
                e = p.e2 + (p.e2 >= 2 * t ? -t : t);
            }
            out = p.pred + e;
        }
        restored[img_off + pos] = (T)out;
    }
}

template <typename T>
static int launch_pee_extract(const void* stego, const void* over,
                              const int* nproc, int batch, int h, int w,
                              int parity, int t, long long out_len,
                              void* restored, void* bits, int* nbits,
                              int* scratch, int tiles, void* stream) {
    if (!pee_shape_ok(batch, h, w, tiles) || out_len < 1 ||
        (parity != 0 && parity != 1) || t < 1) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    int err = (int)cudaMemsetAsync(bits, 0, (size_t)(batch * out_len), s);
    if (err) return err;
    const dim3 grid((unsigned)tiles, (unsigned)batch);
    pee_extract_count_kernel<T><<<grid, PEE_THREADS, 0, s>>>(
        (const T*)stego, (const uint8_t*)over, nproc, h, w, parity, t, tiles,
        scratch);
    err = (int)cudaGetLastError();
    if (err) return err;
    pee_scan_kernel<<<(unsigned)batch, PEE_SCAN_THREADS, 0, s>>>(
        scratch, tiles, nbits, nullptr, nullptr, nullptr, h * w);
    err = (int)cudaGetLastError();
    if (err) return err;
    pee_extract_apply_kernel<T><<<grid, PEE_THREADS, 0, s>>>(
        (const T*)stego, (const uint8_t*)over, nproc, h, w, parity, t, tiles,
        scratch, out_len, (T*)restored, (uint8_t*)bits);
    return (int)cudaGetLastError();
}

extern "C" {

int pee_extract_u8(const void* stego, const void* over, const int* nproc,
                   int batch, int h, int w, int parity, int t,
                   long long out_len, void* restored, void* bits, int* nbits,
                   int* scratch, int tiles, void* stream) {
    return launch_pee_extract<uint8_t>(stego, over, nproc, batch, h, w,
                                       parity, t, out_len, restored, bits,
                                       nbits, scratch, tiles, stream);
}

int pee_extract_u16(const void* stego, const void* over, const int* nproc,
                    int batch, int h, int w, int parity, int t,
                    long long out_len, void* restored, void* bits, int* nbits,
                    int* scratch, int tiles, void* stream) {
    return launch_pee_extract<uint16_t>(stego, over, nproc, batch, h, w,
                                        parity, t, out_len, restored, bits,
                                        nbits, scratch, tiles, stream);
}

}  // extern "C"
