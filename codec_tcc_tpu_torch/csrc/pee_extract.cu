// K4 pee_extract: inverts one prediction-error-expansion pass over a batch.
//
// Replaces (codec_tcc_tpu/ops/pallas_pee.py):
//   _extract_call / _extract_kernel   (pallas_call :781, kernel :639),
//   reached through extract_pass_batch :949 and extract_both_passes_batch
//   :1049, and the host join of its per-tile bit segments (collect_bits
//   :1072).
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
// count of expanded pixels. The bit rows are zero past it.
//
// Bound: bytes. Per pixel it must read the stego and the overflow byte once
// and write the restored pixel once, plus one byte per bit of out_len. At
// 2048x2048 u16 with the 3 Mbit plan (out_len 4,194,304) that is 25.2 MB,
// 7.5 us at 3.35 TB/s.
//
// Design: ONE launch per pass, after one memset of the bit rows and the
// scratch (one allocation), and the stego and the overflow map are read
// from device memory once. Tiles, tickets, runs and the look-back are K3's
// (pee_common.cuh, pee_embed.cu). What differs:
//   * a pixel's restored value depends only on its neighbourhood, nproc and
//     its overflow flag, not on its global rank: in-set pixels of a run have
//     consecutive set ranks from one closed form, so "set rank <= nproc" is
//     a mask of the run's first in-set pixels, and the run's restored pixels
//     are stored from registers before the tile's rank is asked for; the
//     look-back's wait hides behind those stores;
//   * a tile whose first set rank exceeds nproc holds no processed pixel
//     and is a pure copy (as the TPU kernel's tiles past nproc are). These
//     tiles are a suffix of the image, so no active tile waits on one; the
//     last active tile writes nbits[b] after its look-back, and where no
//     tile is active the memset's 0 stands;
//   * only the bit stores need the rank: after the look-back the tile's
//     bits, a contiguous segment of the bit row, are staged in shared
//     memory at the segment's alignment and stored as 16-byte vectors.
// The TPU kernel's compress network, transposed one-hot MXU scatter and
// per-tile segments joined on the host are gone. Out of place: only the
// input stego is read, so no tile sees a neighbour another one rewrote.
//
// What holds it back now (tools/torch_pee_embed_probe.py --kernel extract
// times copies of this source with one part stubbed out; numbers in
// PERF.md): the memset of the bit rows before the launch (about 2 us at
// out_len 4,194,304), the look-back's wait (the tiles of a wave publish
// together, and the walk back to a prefix is a chain of L2 round trips),
// the ticket's atomic, and a body that takes about 1.8 times a plain copy
// of the same bytes: at 4 blocks per SM a 2048x2048 image is two waves of
// tiles that each pay the load latency in full.
//
// Shard mode (BAND, pallas_pee.py `pos_base` :670, :691, reached through
// extract_pass_batch(shard=...) :949; its plain version is ops/pee.py
// `extract_pass_band`): one band of lh rows per image, with the rows above
// and below it (`top`, `bot`) and its first global row `row0`; `h` is the
// image's height and nproc the pass's global boundary. The geometry, the
// copy test of a tile and the last active tile run on global rows; the
// band's bits go to its bit row in band rank order from 0, and nbits is the
// band's count: the caller places a band's bits after the counts of the
// bands above it.
#include "pee_common.cuh"

// Restores pixels k = K0, K0 + STEP, ... of a run with bit k of `proc` set
// (processed), from the run `c`, the rows above and below it and its row
// neighbours; every other pixel keeps c[k]. Bit k of `expm` is set where
// the pixel is expanded (-2t <= e2 < 2t) and bit k of `bitm` holds its bit;
// branch-free, the caller keeps the bits of processed pixels only.
template <int K0, int STEP, typename T, int RUN>
__device__ __forceinline__ void pee_extract_restore(
    const T (&c)[RUN], const T (&up)[RUN], const T (&dn)[RUN], int left,
    int right, int t, unsigned proc, T (&out)[RUN], unsigned& expm,
    unsigned& bitm) {
#pragma unroll
    for (int k = 0; k < RUN; ++k) out[k] = c[k];
#pragma unroll
    for (int k = K0; k < RUN; k += STEP) {
        const int x = c[k];
        const int l = k == 0 ? left : (int)c[k - 1];
        const int r = k == RUN - 1 ? right : (int)c[k + 1];
        // the sum is >= 0: the shift is the floor division
        const int pred = ((int)up[k] + (int)dn[k] + l + r) >> 2;
        const int e2 = x - pred;
        const bool expanded = e2 >= -2 * t && e2 < 2 * t;
        const int bit = e2 & 1;   // floor-mod 2 in two's complement
        const int v = expanded ? pred + ((e2 - bit) >> 1)   // arithmetic
                               : x + (e2 >= 2 * t ? -t : t);
        if ((proc >> k) & 1u) out[k] = (T)v;
        expm |= (unsigned)expanded << k;
        bitm |= (unsigned)bit << k;
    }
}

// At least 4 blocks per SM: 64 registers, no spills in the uint16 kernel
// (uncapped it takes 71 and 3 blocks per SM, about 2 us slower at
// 2048x2048; PERF.md).
// BAND: h is the image's height, lh the band's rows (see the header).
template <typename T, bool BAND>
__global__ void __launch_bounds__(PEE_THREADS, 4)
pee_extract_kernel(const T* __restrict__ stego,
                   const uint8_t* __restrict__ over,
                   const int* __restrict__ nproc, int h, int w, int parity,
                   int t, int tiles, long long out_len,
                   T* __restrict__ restored, uint8_t* __restrict__ bits,
                   int* __restrict__ nbits, unsigned* __restrict__ ticket,
                   unsigned long long* __restrict__ status,
                   const T* __restrict__ top, const T* __restrict__ bot,
                   const int* __restrict__ row0p, int lh) {
    constexpr int RUN = PEE_RUN;
    static_assert(RUN == 16, "the run's masks and overflow bytes are 16 wide");
    __shared__ int s_tile, s_prefix;
    __shared__ int s_warp[PEE_THREADS / 32];
    __shared__ __align__(16) uint8_t s_bits[PEE_TILE_PX + 16];
    const int g = pee_take_ticket(ticket, &s_tile);
    const int b = g / tiles;
    const int tile = g - b * tiles;
    const int n = (BAND ? lh : h) * w;
    const long long img_off = (long long)b * n;
    const T* im = stego + img_off;
    T* out_im = restored + img_off;
    const int tile0 = tile * PEE_TILE_PX;
    const int p0 = tile0 + threadIdx.x * RUN;
    const bool live = p0 < n;
    const int np = nproc[b];
    const int row0 = BAND ? row0p[b] : 0;

    // 1. a tile whose first in-set pixel lies past nproc is a pure copy
    {
        const int ty = tile0 / w;
        if (pee_set_count_before(row0 + ty, tile0 - ty * w, h, w, parity) >=
            np) {
            if (!live) return;
            T c[RUN];
            if (p0 + RUN <= n && ((uintptr_t)(im + p0) & 15) == 0) {
                pee_load_vec(im + p0, c);
            } else {
                pee_load_scalar(im, p0, n, c);
            }
            pee_store_run(out_im, p0, n, c);
            return;
        }
    }

    // 2. the run, its rows above and below, its row neighbours and its
    // overflow flags, all loads issued before any is used
    T c[RUN], up[RUN], dn[RUN];
    int left = 0, right = 0;
    unsigned ovm = 0;
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
    if (live) ovm = pee_load_nonzero16(over + img_off, p0, n);

    // 3. the processed pixels: the run's in-set pixels have consecutive set
    // ranks from (in-set pixels before p0) + 1, so those with set rank <=
    // nproc are its first `room` ones (64-bit: nproc may be any int32)
    unsigned in_set = 0, proc = 0;
    int mode = 2;
    if (live) {
        int y0, x0;
        in_set = pee_run_in_set<RUN, BAND>(p0, h, w, parity, vec, mode, y0,
                                           x0, row0, n);
        const long long room =
            (long long)np - pee_set_count_before(y0, x0, h, w, parity);
        proc = in_set;
        if (room < __popc(in_set)) {
            unsigned rest = in_set;   // in-set pixels past the first `room`
            for (int i = 0; i < (int)max(room, 0LL); ++i) rest &= rest - 1;
            proc = in_set & ~rest;
        }
        proc &= ~ovm;
    }

    // 4. restore from the registers and store the run at once: it needs no
    // rank
    unsigned expm = 0, bitm = 0;
    T out[RUN];
    if (live) {
        if (mode == 0) {
            pee_extract_restore<0, 2>(c, up, dn, left, right, t, proc, out,
                                      expm, bitm);
        } else if (mode == 1) {
            pee_extract_restore<1, 2>(c, up, dn, left, right, t, proc, out,
                                      expm, bitm);
        } else if (proc) {
            pee_extract_restore<0, 1>(c, up, dn, left, right, t, proc, out,
                                      expm, bitm);
        } else {
#pragma unroll
            for (int k = 0; k < RUN; ++k) out[k] = c[k];
        }
    }
    if (live) pee_store_run(out_im, p0, n, out);
    const unsigned expd = expm & proc;

    // 5. rank: block scan of the runs' expanded counts, then the look-back
    const int cnt = __popc(expd);
    int agg;
    const int thread_excl = pee_block_excl_scan<PEE_THREADS>(cnt, s_warp, &agg);
    if (threadIdx.x < 32) {
        const unsigned excl = pee_lookback(status + (long long)b * tiles, tile,
                                           (unsigned)agg);
        if (threadIdx.x == 0) s_prefix = (int)excl;
    }
    __syncthreads();
    const int prefix = s_prefix;

    // 6. the tile's bits are ranks [prefix, prefix + agg) of the image:
    // staged in shared memory at their offsets from the 16-byte boundary
    // below row + prefix, then stored as aligned 16-byte vectors (bytes at
    // the segment's two ends), the part below out_len only
    uint8_t* row = bits + (long long)b * out_len;
    const int shift = (int)((uintptr_t)(row + prefix) & 15);
    {
        unsigned rest = expd;
        for (int j = shift + thread_excl; rest; ++j, rest &= rest - 1) {
            s_bits[j] = (uint8_t)((bitm >> (__ffs(rest) - 1)) & 1u);
        }
    }
    __syncthreads();
    uint8_t* seg = row + prefix - shift;   // 16-byte aligned
    const int end =
        shift + (int)min((long long)agg, max(out_len - prefix, 0LL));
    for (int lo = 16 * threadIdx.x; lo < end; lo += 16 * PEE_THREADS) {
        if (lo >= shift && lo + 16 <= end) {
            *reinterpret_cast<uint4*>(seg + lo) =
                *reinterpret_cast<const uint4*>(s_bits + lo);
        } else {
            for (int k = max(lo, shift); k < min(lo + 16, end); ++k) {
                seg[k] = s_bits[k];
            }
        }
    }
    // the last active tile (the next tile's first in-set pixel lies past
    // nproc, or there is none) holds the image's count
    if (threadIdx.x == 0) {
        const int next0 = tile0 + PEE_TILE_PX;
        const int ny = next0 / w;
        if (tile == tiles - 1 ||
            pee_set_count_before(row0 + ny, next0 - ny * w, h, w, parity) >=
                np) {
            nbits[b] = prefix + agg;
        }
    }
}

// Scratch of one launch, in bytes, in front of the bit rows in the same
// allocation: nbits[B], the ticket, then one 64-bit status word per tile of
// the batch (8-byte aligned).
static long long pee_extract_status_offset(int batch) {
    return (4LL * batch + 4 + 7) & ~7LL;
}

// The wrapper allocates these bytes plus batch * out_len bytes of bits and
// reads nbits from their front.
extern "C" long long pee_extract_scratch_bytes(int batch, int h, int w) {
    return pee_extract_status_offset(batch) + 8LL * batch * pee_tiles(h, w);
}

// BAND: h is the image's height and lh the band's rows; top, bot and row0
// as in the header. Whole images: lh = h and the rest null.
template <typename T, bool BAND>
static int launch_pee_extract(const void* stego, const void* over,
                              const int* nproc, int batch, int h, int w,
                              int parity, int t, long long out_len,
                              void* restored, void* buf, void* stream,
                              const void* top = nullptr,
                              const void* bot = nullptr,
                              const int* row0 = nullptr, int lh = 0) {
    if (!BAND) lh = h;
    // int pixel indices: n + w plus a tile stays below 2**31, and so do the
    // image's set ranks (below h * w)
    if (batch < 1 || h < 1 || w < 1 || lh < 1 || lh > h || out_len < 1 ||
        (parity != 0 && parity != 1) || t < 1 ||
        ((long long)h + 1) * w > 0x7fffffffLL - PEE_TILE_PX ||
        batch * pee_tiles(lh, w) > 0x7fffffffLL ||
        (BAND && (!top || !bot || !row0))) {
        return (int)cudaErrorInvalidValue;
    }
    const long long tiles = pee_tiles(lh, w);
    const long long scratch = pee_extract_scratch_bytes(batch, lh, w);
    uint8_t* base = (uint8_t*)buf;
    cudaStream_t s = (cudaStream_t)stream;
    // zeroes nbits, the ticket, the status words and the bit rows at once
    int err = (int)cudaMemsetAsync(buf, 0,
                                   (size_t)(scratch + batch * out_len), s);
    if (err) return err;
    pee_extract_kernel<T, BAND>
        <<<(unsigned)(batch * tiles), PEE_THREADS, 0, s>>>(
            (const T*)stego, (const uint8_t*)over, nproc, h, w, parity, t,
            (int)tiles, out_len, (T*)restored, base + scratch, (int*)base,
            (unsigned*)(base + 4LL * batch),
            (unsigned long long*)(base + pee_extract_status_offset(batch)),
            (const T*)top, (const T*)bot, row0, lh);
    return (int)cudaGetLastError();
}

extern "C" {

int pee_extract_u8(const void* stego, const void* over, const int* nproc,
                   int batch, int h, int w, int parity, int t,
                   long long out_len, void* restored, void* buf,
                   void* stream) {
    return launch_pee_extract<uint8_t, false>(stego, over, nproc, batch, h,
                                              w, parity, t, out_len,
                                              restored, buf, stream);
}

int pee_extract_u16(const void* stego, const void* over, const int* nproc,
                    int batch, int h, int w, int parity, int t,
                    long long out_len, void* restored, void* buf,
                    void* stream) {
    return launch_pee_extract<uint16_t, false>(stego, over, nproc, batch, h,
                                               w, parity, t, out_len,
                                               restored, buf, stream);
}

// Shard mode: one band of lh rows per image of an image h rows tall; the
// buffer is pee_extract_scratch_bytes(batch, lh, w) + batch * out_len bytes.
int pee_extract_band_u8(const void* stego, const void* over, const int* nproc,
                        const void* top, const void* bot, const int* row0,
                        int batch, int lh, int h, int w, int parity, int t,
                        long long out_len, void* restored, void* buf,
                        void* stream) {
    return launch_pee_extract<uint8_t, true>(stego, over, nproc, batch, h, w,
                                             parity, t, out_len, restored,
                                             buf, stream, top, bot, row0, lh);
}

int pee_extract_band_u16(const void* stego, const void* over,
                         const int* nproc, const void* top, const void* bot,
                         const int* row0, int batch, int lh, int h, int w,
                         int parity, int t, long long out_len, void* restored,
                         void* buf, void* stream) {
    return launch_pee_extract<uint16_t, true>(stego, over, nproc, batch, h,
                                              w, parity, t, out_len,
                                              restored, buf, stream, top, bot,
                                              row0, lh);
}

}  // extern "C"
