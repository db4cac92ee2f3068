// K3 pee_embed: one prediction-error-expansion pass over a batch of images.
//
// Replaces (codec_tcc_tpu/ops/pallas_pee.py):
//   _embed_call / _embed_kernel   (pallas_call :621), reached through
//   embed_pass_batch :842 and embed_both_passes_batch :1002.
// Its plain torch version is codec_tcc_tpu_torch/ops/pee.py `embed_pass`
// (the XLA formulas of codec_tcc_tpu/ops/pee.py :210).
//
// Function, per image b, over the in-set pixels of checkerboard colour
// `parity` in raster order: pred = floor(mean of the 4 neighbours),
// e = x - pred; "expandable" is -t <= e < t; a pixel overflows when the
// expansion 2e + {0,1} or the shift e +- t would leave [0, max_val]; the
// eligible pixels (expandable, no overflow) are ranked globally (grank, 1 =
// first). The pass processes the shortest prefix of the set that holds
// `want` eligible pixels (all of it when want > cap): an eligible pixel with
// grank <= want becomes pred + 2e + msg[msg_base + grank - 1] (index clamped
// to the message), a processed non-expandable one shifts by +-t, processed
// overflow pixels stay and are flagged in the overflow map. Outputs: stego,
// overflow map (u8), cap = eligible count, used = min(want, cap), nproc =
// largest set rank embedded (H*W when want > cap).
//
// Bound: bytes. Per pixel it must read the image once and write the stego
// and the overflow byte once; it reads one message byte per embedded bit.
// At 2048x2048 u16 that is ~21 MB plus the message, ~6.5 us at 3.35 TB/s.
//
// Design. The TPU kernel ran its grid in order on one core and carried the
// running eligible count across tiles in SMEM; CUDA blocks run in no order,
// so the global rank is a three-launch scan written here:
//   (a) count: each block counts its tile's eligible pixels
//       (__syncthreads_count per round);
//   (b) scan: one block per image turns the tile counts into exclusive
//       prefixes and derives cap, used and the saturation seed of nproc;
//   (c) apply: each block recomputes the classification, ranks its pixels
//       with a warp ballot + popcount and a prefix over the 8 warp counts,
//       adds its tile prefix, and writes stego and overflow; nproc is a
//       block max of the embedded set ranks, folded in with atomicMax.
// The 128-lane layout, halo DMAs, one-hot MXU fetches and lane networks of
// the TPU kernel are gone: the image is indexed directly (any geometry, no
// padding), neighbours are plain loads that hit L1/L2, and the message bit
// is one indexed byte load. The pass is out of place: (c) reads only the
// input image, so no block sees a neighbour another block rewrote. The
// image is read twice, by (a) and (c); a single-launch decoupled look-back
// would read it once (later work).
#include "pee_common.cuh"

struct PeeEmbedPixel {
    int x = 0, pred = 0, e = 0;
    bool in_set = false, expandable = false, overflow = false,
         eligible = false;
};

template <typename T>
__device__ __forceinline__ PeeEmbedPixel pee_embed_classify(
    const T* __restrict__ im, int pos, int h, int w, int parity, int t,
    int max_val) {
    PeeEmbedPixel p;
    const int y = pos / w;
    const int xc = pos - y * w;
    p.x = (int)im[pos];
    p.in_set = pee_in_set(y, xc, h, w, parity);
    if (!p.in_set) return p;
    p.pred = pee_predict(im, pos, w);
    p.e = p.x - p.pred;
    p.expandable = p.e >= -t && p.e < t;
    const bool exp_over =
        p.pred + 2 * p.e + 1 > max_val || p.pred + 2 * p.e < 0;
    const bool shift_over = p.e >= t ? p.x + t > max_val : p.x - t < 0;
    p.overflow = p.expandable ? exp_over : shift_over;
    p.eligible = p.expandable && !p.overflow;
    return p;
}

template <typename T>
__global__ void __launch_bounds__(PEE_THREADS)
pee_embed_count_kernel(const T* __restrict__ img, int h, int w, int parity,
                       int t, int max_val, int tiles,
                       int* __restrict__ counts) {
    const int b = blockIdx.y;
    const int n = h * w;
    const T* im = img + (long long)b * n;
    const int tile0 = blockIdx.x * PEE_TILE_PX;
    int cnt = 0;
    for (int r = 0; r < PEE_ROUNDS; ++r) {
        const int pos = tile0 + r * PEE_THREADS + threadIdx.x;
        bool elig = false;
        if (pos < n) {
            elig = pee_embed_classify(im, pos, h, w, parity, t, max_val)
                       .eligible;
        }
        cnt += __syncthreads_count(elig);
    }
    if (threadIdx.x == 0) counts[(long long)b * tiles + blockIdx.x] = cnt;
}

template <typename T>
__global__ void __launch_bounds__(PEE_THREADS)
pee_embed_apply_kernel(const T* __restrict__ img,
                       const uint8_t* __restrict__ msg, long long msg_len,
                       const int* __restrict__ msg_base,
                       const int* __restrict__ want, int h, int w, int parity,
                       int t, int max_val, int tiles,
                       const int* __restrict__ offsets, T* __restrict__ stego,
                       uint8_t* __restrict__ over, int* __restrict__ nproc) {
    __shared__ int warp_cnt[PEE_WARPS];
    __shared__ int warp_max[PEE_WARPS];
    const int b = blockIdx.y;
    const int n = h * w;
    const long long img_off = (long long)b * n;
    const T* im = img + img_off;
    const uint8_t* m = msg + b * msg_len;
    const long long mbase = msg_base[b];
    const int wv = want[b];
    const int tile0 = blockIdx.x * PEE_TILE_PX;
    int carry = offsets[(long long)b * tiles + blockIdx.x];
    int best = 0;   // largest set rank this thread embedded into
    for (int r = 0; r < PEE_ROUNDS; ++r) {
        const int pos = tile0 + r * PEE_THREADS + threadIdx.x;
        const bool valid = pos < n;
        PeeEmbedPixel p;
        if (valid) p = pee_embed_classify(im, pos, h, w, parity, t, max_val);
        int round_total;
        const int excl = pee_block_rank(p.eligible, warp_cnt, &round_total);
        const int grank = carry + excl + (p.eligible ? 1 : 0);   // inclusive
        carry += round_total;
        if (!valid) continue;
        const bool embeds = p.eligible && grank <= wv;
        const bool processed =
            p.in_set && (grank < wv || (p.eligible && grank == wv));
        int out = p.x;
        if (processed && !p.overflow && (embeds || !p.expandable)) {
            int e_new;
            if (p.expandable) {
                long long idx = mbase + grank - 1;
                idx = idx < 0 ? 0 : (idx >= msg_len ? msg_len - 1 : idx);
                e_new = 2 * p.e + (int)m[idx];
            } else {
                e_new = p.e + (p.e >= t ? t : -t);
            }
            out = p.pred + e_new;
        }
        stego[img_off + pos] = (T)out;
        over[img_off + pos] = (processed && p.overflow) ? 1 : 0;
        if (embeds) {
            const int y = pos / w;
            best = max(best, pee_set_rank(y, pos - y * w, h, w, parity));
        }
    }
    // block max of the embedded set ranks -> nproc[b]
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    best = __reduce_max_sync(0xffffffffu, best);
    if (lane == 0) warp_max[warp] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
        int bm = 0;
#pragma unroll
        for (int k = 0; k < PEE_WARPS; ++k) bm = max(bm, warp_max[k]);
        if (bm > 0) atomicMax(nproc + b, bm);
    }
}

template <typename T>
static int launch_pee_embed(const void* img, const void* msg,
                            long long msg_len, const int* msg_base,
                            const int* want, int batch, int h, int w,
                            int parity, int t, int max_val, void* stego,
                            void* over, int* used, int* nproc, int* cap,
                            int* scratch, int tiles, void* stream) {
    if (!pee_shape_ok(batch, h, w, tiles) || msg_len < 1 ||
        (parity != 0 && parity != 1) || t < 1) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((unsigned)tiles, (unsigned)batch);
    pee_embed_count_kernel<T><<<grid, PEE_THREADS, 0, s>>>(
        (const T*)img, h, w, parity, t, max_val, tiles, scratch);
    int err = (int)cudaGetLastError();
    if (err) return err;
    pee_scan_kernel<<<(unsigned)batch, PEE_SCAN_THREADS, 0, s>>>(
        scratch, tiles, cap, want, used, nproc, h * w);
    err = (int)cudaGetLastError();
    if (err) return err;
    pee_embed_apply_kernel<T><<<grid, PEE_THREADS, 0, s>>>(
        (const T*)img, (const uint8_t*)msg, msg_len, msg_base, want, h, w,
        parity, t, max_val, tiles, scratch, (T*)stego, (uint8_t*)over, nproc);
    return (int)cudaGetLastError();
}

extern "C" {

// Pixels per block of both PEE kernels: the wrappers size the per-tile
// scratch from it.
int pee_tile_px(void) { return PEE_TILE_PX; }

int pee_embed_u8(const void* img, const void* msg, long long msg_len,
                 const int* msg_base, const int* want, int batch, int h, int w,
                 int parity, int t, int max_val, void* stego, void* over,
                 int* used, int* nproc, int* cap, int* scratch, int tiles,
                 void* stream) {
    return launch_pee_embed<uint8_t>(img, msg, msg_len, msg_base, want, batch,
                                     h, w, parity, t, max_val, stego, over,
                                     used, nproc, cap, scratch, tiles, stream);
}

int pee_embed_u16(const void* img, const void* msg, long long msg_len,
                  const int* msg_base, const int* want, int batch, int h,
                  int w, int parity, int t, int max_val, void* stego,
                  void* over, int* used, int* nproc, int* cap, int* scratch,
                  int tiles, void* stream) {
    return launch_pee_embed<uint16_t>(img, msg, msg_len, msg_base, want,
                                      batch, h, w, parity, t, max_val, stego,
                                      over, used, nproc, cap, scratch, tiles,
                                      stream);
}

}  // extern "C"
