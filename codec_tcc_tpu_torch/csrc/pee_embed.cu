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
// Design: ONE launch per pass (after one memset of its scratch), and the
// image is read from device memory once. The TPU kernel ran its grid in
// order on one core and carried the running eligible count across tiles in
// SMEM; CUDA blocks run in no order, so:
//   * a block takes a ticket (its tile, in start order, over all tiles of
//     the batch) and owns PEE_TILE_PX consecutive pixels of one image;
//     each thread owns a run of PEE_RUN of them. The run and the runs
//     above and below it (+-w) come in 16-byte vector loads where aligned
//     (scalar loads, which hit L1/L2, where not), all issued before any is
//     used. One division gives the run's (y, x); inside one interior row
//     the in-set pixels are every other pixel, so only those eight are
//     classified and applied, branch-free (a run that crosses a row end
//     takes all sixteen). Each pixel stays in a register as x | alt << 16
//     (alt: what it becomes if processed), with expandable and overflow
//     bit masks;
//   * one block scan of the runs' eligible counts (warp shuffles plus a
//     scan of the warp totals), then a decoupled look-back over the tiles
//     before it in the same image (pee_common.cuh) gives the tile's offset;
//   * the apply needs no cap: embeds = eligible && grank <= want, processed
//     = in_set && (grank < want || eligible && grank == want), so a run's
//     processed pixels are its in-set pixels up to the want-th eligible
//     pixel of the image. That one pixel writes nproc (its set rank); the
//     image's last tile writes cap, used and, when want > cap, nproc = H*W.
//     These writers exclude each other, so no atomics are needed, and the
//     memset's zero stands where no pixel writes (want <= 0). A run's
//     message bits are consecutive bytes, loaded together before use.
// The 128-lane layout, halo DMAs, one-hot MXU fetches and lane networks of
// the TPU kernel are gone: the image is indexed directly (any geometry, no
// padding). The pass is out of place: only the input image is read, so no
// tile sees a neighbour another one rewrote.
//
// What holds it back now (measured with tools/torch_pee_embed_probe.py,
// which times copies of this source with one part stubbed out; numbers in
// PERF.md): at 4 blocks per SM a 2048x2048 image is about two waves of
// tiles that move in lockstep, and each wave pays in series the ticket's
// atomic, the loads, the look-back's wait on the tiles before it and the
// message loads that need the rank; the body alone (loads, classify,
// scan, apply, stores) takes about twice the time of a plain copy of the
// same bytes.
//
// Shard mode (BAND, pallas_pee.py `pos_base`/`rank_base` :481-489, :536,
// reached through embed_pass_batch(shard=...) :876-942; its plain version
// is ops/pee.py `embed_pass_band`): the launch takes one band of lh rows
// per image, with the rows above and below it (`top`, `bot`), its first
// global row `row0` and the eligible count of the rows above it
// (`rank_base`); `h` is the image's height and `want` the whole pass's. The
// geometry runs on global rows, and the tiles' ranks, from the look-back
// over the band's own tiles, are offset by rank_base. The band's first and
// last rows take their neighbours from top/bot by scalar loads (a pointer
// into each row; no padded copy of the band). Outputs: the band's stego and
// overflow, its own eligible count (in cap; every tile counts, so it is
// exact) and nproc = the largest set rank the band processes: the
// want-th eligible pixel's, or the band's last in-set pixel's when the
// whole band is processed (want > rank_base + its count), else 0. No
// saturation fixup: the caller combines the bands (used = min(want, cap),
// nproc = H*W when want > cap).
#include "pee_common.cuh"

// Classifies pixels k = K0, K0 + STEP, ... of a run, from the run `c`, the
// rows above and below it and its row neighbours: xa[k] = x | alt << 16,
// where alt is what a processed pixel becomes before its message bit (the
// expansion 2x - pred = pred + 2e when expandable, else the shift x +- t),
// and bit k of `expm` (expandable) and `ovfm` (overflow). Branch-free; the
// caller keeps only the bits of in-set pixels.
template <int K0, int STEP, typename T, int RUN>
__device__ __forceinline__ void pee_embed_classify(
    const T (&c)[RUN], const T (&up)[RUN], const T (&dn)[RUN], int left,
    int right, int t, int max_val, uint32_t (&xa)[RUN], unsigned& expm,
    unsigned& ovfm) {
#pragma unroll
    for (int k = K0; k < RUN; k += STEP) {
        const int x = c[k];
        const int l = k == 0 ? left : (int)c[k - 1];
        const int r = k == RUN - 1 ? right : (int)c[k + 1];
        // the sum is >= 0: the shift is the floor division
        const int pred = ((int)up[k] + (int)dn[k] + l + r) >> 2;
        const int e = x - pred;
        const bool expandable = e >= -t && e < t;
        const int v = 2 * x - pred;
        const int s = x + (e >= t ? t : -t);
        const bool over = expandable ? v + 1 > max_val || v < 0
                                     : (e >= t ? s > max_val : s < 0);
        // alt fits 16 bits wherever it is used (no overflow: 0 <= alt <=
        // max_val < 2**16, checked at the launch)
        xa[k] = (uint32_t)x | (uint32_t)(expandable ? v : s) << 16;
        expm |= (unsigned)expandable << k;
        ovfm |= (unsigned)over << k;
    }
}

// The stego run: pixels k = K0, K0 + STEP, ... with bit k of `change` set
// (processed, no overflow) become alt, plus their message bit when
// expandable: the r-th byte of `mw` for the pixel with r eligible pixels
// before it in the run. Every other pixel keeps x. The (T) cast wraps a
// uint8 pixel past 255 when max_val > 255 (BitsStored > 8), as the plain
// version's .to(dtype) and the JAX package do.
template <int K0, int STEP, typename T, int RUN>
__device__ __forceinline__ void pee_embed_apply(
    const uint32_t (&xa)[RUN], unsigned change, unsigned expm, unsigned elig,
    const uint32_t (&mw)[RUN / 4], T (&out)[RUN]) {
#pragma unroll
    for (int k = 0; k < RUN; ++k) out[k] = (T)(xa[k] & 0xffffu);
#pragma unroll
    for (int k = K0; k < RUN; k += STEP) {
        const int r = __popc(elig & ((1u << k) - 1u));
        const uint32_t lo = r < 8 ? mw[0] : mw[2];
        const uint32_t hi = r < 8 ? mw[1] : mw[3];
        const int bit = (expm >> k) & 1u
                            ? (int)(__byte_perm(lo, hi, r & 7) & 0xffu)
                            : 0;
        if ((change >> k) & 1u) out[k] = (T)((int)(xa[k] >> 16) + bit);
    }
}

// BAND: h is the image's height, lh the band's rows (see the header).
template <typename T, bool BAND>
__global__ void __launch_bounds__(PEE_THREADS)
pee_embed_kernel(const T* __restrict__ img, const uint8_t* __restrict__ msg,
                 long long msg_len, const int* __restrict__ msg_base,
                 const int* __restrict__ want, int h, int w, int parity, int t,
                 int max_val, int tiles, T* __restrict__ stego,
                 uint8_t* __restrict__ over, int* __restrict__ used,
                 int* __restrict__ nproc, int* __restrict__ cap,
                 unsigned* __restrict__ ticket,
                 unsigned long long* __restrict__ status,
                 const T* __restrict__ top, const T* __restrict__ bot,
                 const int* __restrict__ row0p,
                 const int* __restrict__ rank_base, int lh) {
    constexpr int RUN = PEE_RUN;
    static_assert(RUN == 16, "the run's masks and overflow bytes are 16 wide");
    __shared__ int s_tile, s_prefix;
    __shared__ int s_warp[PEE_THREADS / 32];
    const int g = pee_take_ticket(ticket, &s_tile);
    const int b = g / tiles;
    const int tile = g - b * tiles;
    const int n = (BAND ? lh : h) * w;
    const long long img_off = (long long)b * n;
    const T* im = img + img_off;
    const int p0 = tile * PEE_TILE_PX + threadIdx.x * RUN;
    const bool live = p0 < n;
    const int row0 = BAND ? row0p[b] : 0;

    // 1. the run, its rows above and below and its row neighbours, all
    // loads issued before any is used
    T c[RUN], up[RUN], dn[RUN];
    int left = 0, right = 0;
    const bool vec = live && pee_rows_vectorizable<T, RUN>(im, p0, w, n);
    if (vec) {
        left = im[p0 - 1];
        right = im[p0 + RUN];
        pee_load_vec(im + p0, c);
        pee_load_vec(im + p0 - w, up);
        pee_load_vec(im + p0 + w, dn);
    } else if (live) {
        // an in-set pixel is interior, so its row neighbours are in range
        left = p0 > 0 ? im[p0 - 1] : 0;
        right = p0 + RUN < n ? im[p0 + RUN] : 0;
        pee_load_scalar(im, p0, n, c);
        if (BAND) {   // the band's first and last rows: top and bot
            pee_load_band_scalar(im, top + (long long)b * w,
                                 bot + (long long)b * w, p0 - w, n, w, up);
            pee_load_band_scalar(im, top + (long long)b * w,
                                 bot + (long long)b * w, p0 + w, n, w, dn);
        } else {
            pee_load_scalar(im, p0 - w, n, up);
            pee_load_scalar(im, p0 + w, n, dn);
        }
    }

    // 2. the in-set pixels of the run. Inside one interior row they are
    // every other pixel from k0 (mode k0: only those are classified);
    // elsewhere, pixel by pixel (mode 2: all sixteen are)
    unsigned in_set = 0;
    int mode = 2;
    if (live) {
        int y0, x0;
        in_set = pee_run_in_set<RUN, BAND>(p0, h, w, parity, vec, mode, y0,
                                           x0, row0, n);
    }

    // 3. classify: x | alt << 16 per pixel, expandable and overflow bits
    uint32_t xa[RUN];
#pragma unroll
    for (int k = 0; k < RUN; ++k) xa[k] = (uint32_t)c[k];
    unsigned expm = 0, ovfm = 0;
    if (mode == 0) {
        pee_embed_classify<0, 2>(c, up, dn, left, right, t, max_val, xa, expm,
                                 ovfm);
    } else if (mode == 1) {
        pee_embed_classify<1, 2>(c, up, dn, left, right, t, max_val, xa, expm,
                                 ovfm);
    } else if (in_set) {
        pee_embed_classify<0, 1>(c, up, dn, left, right, t, max_val, xa, expm,
                                 ovfm);
    }
    expm &= in_set;
    ovfm &= in_set;
    const unsigned elig = expm & ~ovfm;

    // 4. rank: block scan of the runs' counts, then the look-back
    const int cnt = __popc(elig);
    int agg;
    const int thread_excl =
        pee_block_excl_scan<PEE_THREADS>(cnt, s_warp, &agg);
    if (threadIdx.x < 32) {
        const unsigned excl = pee_lookback(status + (long long)b * tiles, tile,
                                           (unsigned)agg);
        if (threadIdx.x == 0) s_prefix = (int)excl;
    }
    __syncthreads();
    const int rbase = BAND ? rank_base[b] : 0;
    const int prefix = rbase + s_prefix;
    const int wv = want[b];
    if (tile == tiles - 1 && threadIdx.x == 0) {
        const int total = prefix + agg;
        if (BAND) {
            cap[b] = total - rbase;   // the band's own count
            // the whole band is processed: its last in-set pixel
            const int end = pee_set_count_before(row0 + lh, 0, h, w, parity);
            if (wv > total &&
                end > pee_set_count_before(row0, 0, h, w, parity)) {
                nproc[b] = end;
            }
        } else {
            cap[b] = total;
            used[b] = min(wv, total);
            if (wv > total) nproc[b] = n;   // saturated: the whole set
        }
    }
    if (!live) return;

    // 5. the processed pixels of the run: with `base` eligible pixels before
    // it, all in-set ones if the want-th eligible pixel lies past the run,
    // none if before it, else those up to it (that pixel writes nproc)
    const int base = prefix + thread_excl;
    unsigned proc = 0;
    if (wv > base + cnt) {
        proc = in_set;
    } else if (wv > base) {
        unsigned rest = elig;
        for (int i = base + 1; i < wv; ++i) rest &= rest - 1;
        const int kw = __ffs(rest) - 1;
        proc = in_set & ((2u << kw) - 1u);
        const int pos = p0 + kw;
        const int y = pos / w;
        nproc[b] = pee_set_rank(row0 + y, pos - y * w, h, w, parity);
    }
    // the processed eligible pixels embed the run's message bits, which are
    // consecutive: load them all first, one byte each
    const int n_emb = __popc(proc & elig);
    uint32_t mw[RUN / 4];
#pragma unroll
    for (int j = 0; j < RUN / 4; ++j) mw[j] = 0;
    const uint8_t* m = msg + (long long)b * msg_len;
    const long long m0 = (long long)msg_base[b] + base;   // its first bit
    if (m0 >= 0 && m0 + n_emb <= msg_len) {
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
            if (j < n_emb) mw[j / 4] |= (uint32_t)m[m0 + j] << (8 * (j % 4));
        }
    } else {   // the index clamped to [0, msg_len)
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
            long long idx = m0 + j;
            idx = idx < 0 ? 0 : (idx >= msg_len ? msg_len - 1 : idx);
            if (j < n_emb) mw[j / 4] |= (uint32_t)m[idx] << (8 * (j % 4));
        }
    }

    // 6. apply, from the registers
    T out[RUN];
    const unsigned change = proc & ~ovfm;
    if (mode == 0) {
        pee_embed_apply<0, 2>(xa, change, expm, elig, mw, out);
    } else if (mode == 1) {
        pee_embed_apply<1, 2>(xa, change, expm, elig, mw, out);
    } else {
        pee_embed_apply<0, 1>(xa, change, expm, elig, mw, out);
    }
    pee_store_run(stego + img_off, p0, n, out);
    pee_store_mask16(over + img_off, p0, n, proc & ovfm);
}

// Scratch of one launch, in int32s: used[B], nproc[B], cap[B], the ticket,
// then one 64-bit status word per tile of the batch (8-byte aligned).
static long long pee_embed_status_offset(int batch) {
    return (3LL * batch + 2) & ~1LL;   // 3B + 1 rounded up to even
}

// BAND: h is the image's height and lh the band's rows; top, bot, row0 and
// rank_base as in the header. Whole images: lh = h and the rest null.
template <typename T, bool BAND>
static int launch_pee_embed(const void* img, const void* msg,
                            long long msg_len, const int* msg_base,
                            const int* want, int batch, int h, int w,
                            int parity, int t, int max_val, void* stego,
                            void* over, int* scratch, void* stream,
                            const void* top = nullptr,
                            const void* bot = nullptr,
                            const int* row0 = nullptr,
                            const int* rank_base = nullptr, int lh = 0) {
    if (!BAND) lh = h;
    // int pixel indices: n + w plus a tile stays below 2**31, and so do the
    // image's set ranks (below h * w)
    // max_val < 2**16: a processed pixel's alt is packed in 16 bits
    if (batch < 1 || h < 1 || w < 1 || lh < 1 || lh > h || msg_len < 1 ||
        (parity != 0 && parity != 1) || t < 1 || max_val < 0 ||
        max_val > 0xffff ||
        ((long long)h + 1) * w > 0x7fffffffLL - PEE_TILE_PX ||
        batch * pee_tiles(lh, w) > 0x7fffffffLL ||
        (BAND && (!top || !bot || !row0 || !rank_base))) {
        return (int)cudaErrorInvalidValue;
    }
    const long long tiles = pee_tiles(lh, w);
    const long long st_off = pee_embed_status_offset(batch);
    cudaStream_t s = (cudaStream_t)stream;
    int err = (int)cudaMemsetAsync(
        scratch, 0, (size_t)(st_off + 2 * batch * tiles) * sizeof(int), s);
    if (err) return err;
    pee_embed_kernel<T, BAND>
        <<<(unsigned)(batch * tiles), PEE_THREADS, 0, s>>>(
            (const T*)img, (const uint8_t*)msg, msg_len, msg_base, want, h, w,
            parity, t, max_val, (int)tiles, (T*)stego, (uint8_t*)over,
            scratch, scratch + batch, scratch + 2 * batch,
            (unsigned*)(scratch + 3 * batch),
            (unsigned long long*)(scratch + st_off), (const T*)top,
            (const T*)bot, row0, rank_base, lh);
    return (int)cudaGetLastError();
}

extern "C" {

// The tile of K3 and K4 (pixels per block), and the int32s of scratch a K3
// launch takes: its wrapper allocates them and reads used, nproc and cap
// from their front.
int pee_tile_pixels(void) { return PEE_TILE_PX; }

long long pee_embed_scratch_ints(int batch, int h, int w) {
    return pee_embed_status_offset(batch) +
           2LL * batch * pee_tiles(h, w);
}

int pee_embed_u8(const void* img, const void* msg, long long msg_len,
                 const int* msg_base, const int* want, int batch, int h, int w,
                 int parity, int t, int max_val, void* stego, void* over,
                 int* scratch, void* stream) {
    return launch_pee_embed<uint8_t, false>(img, msg, msg_len, msg_base,
                                            want, batch, h, w, parity, t,
                                            max_val, stego, over, scratch,
                                            stream);
}

int pee_embed_u16(const void* img, const void* msg, long long msg_len,
                  const int* msg_base, const int* want, int batch, int h,
                  int w, int parity, int t, int max_val, void* stego,
                  void* over, int* scratch, void* stream) {
    return launch_pee_embed<uint16_t, false>(img, msg, msg_len, msg_base,
                                             want, batch, h, w, parity, t,
                                             max_val, stego, over, scratch,
                                             stream);
}

// Shard mode: one band of lh rows per image of an image h rows tall. The
// scratch is pee_embed_scratch_ints(batch, lh, w) int32s; the band's count
// lands where cap does, nproc where it does, used stays 0.
int pee_embed_band_u8(const void* img, const void* msg, long long msg_len,
                      const int* msg_base, const int* want, const void* top,
                      const void* bot, const int* row0, const int* rank_base,
                      int batch, int lh, int h, int w, int parity, int t,
                      int max_val, void* stego, void* over, int* scratch,
                      void* stream) {
    return launch_pee_embed<uint8_t, true>(img, msg, msg_len, msg_base, want,
                                           batch, h, w, parity, t, max_val,
                                           stego, over, scratch, stream, top,
                                           bot, row0, rank_base, lh);
}

int pee_embed_band_u16(const void* img, const void* msg, long long msg_len,
                       const int* msg_base, const int* want, const void* top,
                       const void* bot, const int* row0, const int* rank_base,
                       int batch, int lh, int h, int w, int parity, int t,
                       int max_val, void* stego, void* over, int* scratch,
                       void* stream) {
    return launch_pee_embed<uint16_t, true>(img, msg, msg_len, msg_base,
                                            want, batch, h, w, parity, t,
                                            max_val, stego, over, scratch,
                                            stream, top, bot, row0,
                                            rank_base, lh);
}

}  // extern "C"
