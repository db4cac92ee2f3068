// The deflate codec's encode of one image on the card: zlib's
// compressobj(1, DEFLATED, 15, 9, Z_RLE) bytes, bit for bit, with the
// codec's 13-byte SDFL header in front.
//
// Replaces no TPU kernel: the JAX package compresses on the host, and so
// did the port until the stego, which is already on the card, was copied
// down only to be compressed by one host thread. Its plain version, and the
// spec of every stage below, is codec_tcc_tpu_torch/ops/deflate_rle.py
// (`deflate_rle_plain`, checked against zlib on the CPU).
//
// The stream is the image read as the codec splits it: uint16 as all low
// bytes, then all high bytes (byte i < n is pixel i's low byte); uint8 as it
// is. It is never materialised.
//
// zlib's deflate_rle at level 1 finds only runs of a byte equal to the one
// before it, so its tokens are a function of the maximal runs (see the
// plain version's rle_tokens): the run's first byte is a literal, then
// every 258th byte starts a match of min(258, bytes left in the run) when
// that is 3 or more, else a literal, and the run's last byte is a second
// literal where two were left. A block ends after every 32,767 tokens and at
// the end, and _tr_flush_block picks stored, static or dynamic Huffman from
// sizes trees.c computes; a block whose first byte zlib's window has slid
// past cannot be stored (buf == NULL).
//
// Bound: bytes. The stream is read once (2n bytes for uint16) and the
// compressed stream written once; everything else is a few hundred bytes a
// tile or a block. 2048x2048 uint16: 8.4 MB read, ~5.3 MB written, ~4 us at
// 3.35 TB/s. What holds the kernels back instead is the serial Huffman
// tree of each block (one thread, a few thousand dependent heap steps).
//
// Design, three launches after one memset (the wrapper's workspace and
// output, which the emit launch only ORs into):
//   1. deflate_rle_tokens: a block takes a tile of DF_TILE stream bytes by
//      ticket, each thread 16 of them in registers (16-byte vector loads
//      where aligned). A byte's run start comes from a block max-scan and a
//      decoupled look-back over the tiles' last run starts; its run end from
//      a reverse min-scan and a halo of the 258 bytes after the tile. A
//      block sum-scan and a second look-back give each token its global
//      index, so its deflate block (index / 32767). The tile's symbol counts
//      go to shared memory (a tile meets at most two deflate blocks), then
//      to each block's counts; each block's first and last token positions
//      and the Adler-32 sums are recorded.
//   2. deflate_rle_trees: one block of threads per deflate block; one
//      thread runs trees.c as it is (build_tree's heap with the depth
//      tie-break, gen_bitlen's overflow repair, gen_codes, scan_tree,
//      build_bl_tree) and the choice; the threads count the block's bits.
//      The last block to finish lays the deflate blocks out in order (a
//      stored block aligns after its 3-bit header) and writes the length.
//   3. deflate_rle_emit: the tile blocks redo step 1's tokens from the
//      recorded tile prefixes, look back over the tiles' bit counts, and
//      OR each token's code into the output at its bit offset; one block
//      per deflate block writes its header, trees, end code and, for a
//      stored block, its bytes; the last one adds the SDFL and zlib headers
//      and the Adler-32 trailer. Every write is an atomicOr into zeroed
//      words, so writers that share a word need no order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pee_common.cuh"   // tickets, look-back, block scans

#define DF_THREADS 256
#define DF_RUN 16                       // stream bytes per thread
#define DF_TILE (DF_THREADS * DF_RUN)
#define DF_HALO 260                     // bytes past a tile for run ends
#define DF_BLOCK_TOKENS 32767           // lit_bufsize - 1 at memLevel 9
#define DF_MAX_MATCH 258
#define DF_L_CODES 286
#define DF_D_CODES 30
#define DF_BL_CODES 19
#define DF_HEAP_SIZE (2 * DF_L_CODES + 1)
#define DF_SYMS (DF_L_CODES + 1)        // lit/len counts, then the matches
#define DF_TREE_THREADS 128
#define DF_LAYOUT 256                   // blocks per step of the layout
#define DF_OUT_BASE 15                  // SDFL header (13) + zlib header (2)
#define DF_MAX_STREAM ((1 << 28) - 1)   // bit counts stay within 32 bits
#define DF_ADLER 65521u

// Written by the kernels for the wrapper, at the front of the workspace.
struct DfHead {
    long long out_len;                  // bytes of the result: read back
    unsigned long long total_bits;      // deflate bits after the zlib header
    unsigned long long adler1, adler2;  // sum b, sum of (pos mod 65521) * b
    unsigned ticket1, ticket3, done2;
    int ntok;
};

// One deflate block, as the trees launch leaves it for the emit launch.
struct DfBlock {
    int kind;           // 0 stored, 1 static, 2 dynamic (trees.c)
    int last;
    int start;          // first stream byte
    int stored_len;     // stream bytes
    int max_lcode, max_dcode, max_blindex;
    unsigned eob;       // end code: len << 16 | bit-reversed code
    unsigned dist0;     // distance code 0 (distance 1), the same way
    unsigned hdr_bits;  // after the 3-bit block header for a stored block
    unsigned data_bits; // tokens and end code (Huffman blocks)
    unsigned tok_bits;  // the tokens' bits as the emit launch counts them
    unsigned long long hdr_bit, data_bit, pfirst;   // the layout
    unsigned bl[DF_BL_CODES];
    unsigned char dist_len[DF_D_CODES];
};

struct DfWs {
    DfHead* head;
    unsigned long long* st_r0;    // look-back: last run start (+1), max
    unsigned long long* st_tok;   // look-back: tokens, sum
    unsigned long long* st_bits;  // look-back: token bits, sum
    int* tile_r0;                 // last run start before the tile, or -1
    int* tile_tok;                // tokens before the tile
    unsigned* hist;               // (nbmax, DF_SYMS) symbol counts
    int* blk_start;               // first token's position per block
    int* blk_last;                // last token's position per block
    DfBlock* blocks;
    unsigned* lit;                // (nbmax, DF_L_CODES) len << 16 | code
};

template <typename T>
struct DfSrc {
    const T* px;
    int n_px;       // pixels
    int nbytes;     // stream bytes: n_px * sizeof(T)

    __device__ __forceinline__ unsigned at(int i) const {
        if (sizeof(T) == 1) return __ldg((const uint8_t*)px + i);
        return i < n_px ? (__ldg(px + i) & 0xFFu)
                        : ((unsigned)__ldg(px + (i - n_px)) >> 8);
    }
};

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------

// Length code (0..28 for symbols 257..285), extra bits and their value of a
// match of length lc + 3 (trees.c _length_code / base_length).
__device__ __forceinline__ void df_length_code(int lc, int& code, int& xbits,
                                               int& xval) {
    if (lc == 255) {
        code = 28, xbits = 0, xval = 0;
    } else if (lc < 8) {
        code = lc, xbits = 0, xval = 0;
    } else {
        const int e = 29 - __clz(lc);   // floor(log2(lc)) - 2
        code = 4 * e + 4 + ((lc >> e) & 3);
        xbits = e;
        xval = lc & ((1 << e) - 1);
    }
}

__device__ __forceinline__ int df_extra_lbits(int sym) {   // sym >= 257
    const int code = sym - 257;
    return (code < 8 || code == 28) ? 0 : (code >> 2) - 1;
}

__device__ __forceinline__ int df_extra_blbits(int n) {
    return n == 16 ? 2 : n == 17 ? 3 : n == 18 ? 7 : 0;
}

__device__ __forceinline__ unsigned df_rev(unsigned code, int len) {
    return len ? __brev(code) >> (32 - len) : 0u;
}

// The static literal/length tree (trees.c tr_static_init): length << 16 |
// bit-reversed code.
__device__ __forceinline__ unsigned df_static_lit(int n) {
    unsigned len, code;
    if (n < 144) len = 8, code = 0x30 + n;
    else if (n < 256) len = 9, code = 0x190 + (n - 144);
    else if (n < 280) len = 7, code = n - 256;
    else len = 8, code = 0xC0 + (n - 280);
    return len << 16 | df_rev(code, (int)len);
}

__device__ __forceinline__ unsigned df_static_len(int n) {
    return n < 144 ? 8 : n < 256 ? 9 : n < 280 ? 7 : 8;
}

// zlib's send_bits into zeroed 32-bit words: fields go in LSB first from an
// absolute bit position; full words and the last partial one are ORed in.
struct DfBits {
    unsigned* out;
    unsigned long long acc;
    unsigned long long word_bit;   // bit position of acc's bit 0
    int fill;

    __device__ __forceinline__ void start(unsigned long long bit) {
        word_bit = bit & ~31ull;
        fill = (int)(bit & 31);
        acc = 0;
    }
    __device__ __forceinline__ void put(unsigned value, int nbits) {
        acc |= (unsigned long long)value << fill;
        fill += nbits;
        if (fill >= 32) {
            atomicOr(out + (word_bit >> 5), (unsigned)acc);
            acc >>= 32;
            fill -= 32;
            word_bit += 32;
        }
    }
    __device__ __forceinline__ void flush() {
        if (fill > 0) atomicOr(out + (word_bit >> 5), (unsigned)acc);
        fill = 0;
        acc = 0;
    }
};

__device__ __forceinline__ void df_or_byte(unsigned* out, long long at,
                                           unsigned byte) {
    atomicOr(out + (at >> 2), (byte & 0xFFu) << (8 * (at & 3)));
}

// Exclusive max of v over the block's threads in thread order (-1 before
// thread 0) and the block's max. One barrier; `warp_tot` not reused after.
__device__ __forceinline__ int df_block_excl_max(int v, int* warp_tot,
                                                 int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x = max(x, y);
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    int before = -1, all = -1;
#pragma unroll
    for (int k = 0; k < DF_THREADS / 32; ++k) {
        const int c = warp_tot[k];
        if (k < warp) before = max(before, c);
        all = max(all, c);
    }
    *total = all;
    const int up = __shfl_up_sync(0xffffffffu, x, 1);
    return max(before, lane ? up : -1);
}

// Exclusive min of v over the threads after this one (`none` after the
// last). One barrier; `warp_tot` not reused after.
__device__ __forceinline__ int df_block_excl_min_after(int v, int* warp_tot,
                                                       int none) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_down_sync(0xffffffffu, x, o);
        if (lane + o < 32) x = min(x, y);
    }
    if (lane == 0) warp_tot[warp] = x;
    __syncthreads();
    int after = none;
#pragma unroll
    for (int k = 0; k < DF_THREADS / 32; ++k) {
        if (k > warp) after = min(after, warp_tot[k]);
    }
    const int down = __shfl_down_sync(0xffffffffu, x, 1);
    return min(after, lane < 31 ? down : none);
}

// pee_lookback with max in place of sum: the largest value (last run start
// + 1, 0 for none) over the tiles before `tile`.
__device__ __forceinline__ unsigned df_lookback_max(unsigned long long* st,
                                                    int tile, unsigned agg) {
    const int lane = threadIdx.x & 31;
    if (tile == 0) {
        if (lane == 0) pee_st_publish(st, PEE_ST_PREFIX | agg);
        return 0;
    }
    if (lane == 0) pee_st_publish(st + tile, PEE_ST_AGGREGATE | agg);
    unsigned excl = 0;
    for (int last = tile - 1;; last -= 32) {
        const int i = last - lane;
        unsigned long long word;
        unsigned prefixes;
        for (;;) {
            word = i >= 0 ? pee_st_read(st + i) : PEE_ST_PREFIX;
            prefixes = __ballot_sync(0xffffffffu, (word >> 32) == 2);
            const unsigned empty =
                __ballot_sync(0xffffffffu, (word >> 32) == 0);
            const unsigned needed =
                prefixes ? prefixes ^ (prefixes - 1) : 0xffffffffu;
            if (!(empty & needed)) break;
            __nanosleep(32);
        }
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        excl = max(excl, __reduce_max_sync(
                             0xffffffffu, lane <= stop ? (unsigned)word : 0u));
        if (prefixes) break;
    }
    if (lane == 0) {
        pee_st_publish(st + tile, PEE_ST_PREFIX | max(excl, agg));
    }
    return excl;
}

// ---------------------------------------------------------------------------
// a tile's tokens (launches 1 and 3)
// ---------------------------------------------------------------------------

// This thread's 16 stream bytes from c (nv of them valid) and the mask of
// those that start a run (differ from the byte before; byte 0 always).
template <typename T>
__device__ __forceinline__ unsigned df_load_run(const DfSrc<T>& s, int c,
                                                unsigned b[DF_RUN], int& nv) {
    nv = max(0, min(DF_RUN, s.nbytes - c));
    bool vec = false;
    const T* p = nullptr;
    if (nv == DF_RUN) {
        if (sizeof(T) == 1) {
            p = s.px + c;
        } else {
            const bool lo = c + DF_RUN <= s.n_px;
            if (lo || c >= s.n_px) p = s.px + (lo ? c : c - s.n_px);
        }
        vec = p && ((uintptr_t)p & 15) == 0;
    }
    if (vec && sizeof(T) == 1) {
        const uint4 v = __ldg((const uint4*)p);
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < DF_RUN; ++k) {
            b[k] = (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
        }
    } else if (vec) {
        const uint4 v0 = __ldg((const uint4*)p);
        const uint4 v1 = __ldg((const uint4*)p + 1);
        const unsigned w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
        const int sh = c < s.n_px ? 0 : 8;
#pragma unroll
        for (int k = 0; k < DF_RUN; ++k) {
            b[k] = (w[k >> 1] >> (16 * (k & 1) + sh)) & 0xFFu;
        }
    } else {
#pragma unroll
        for (int k = 0; k < DF_RUN; ++k) b[k] = k < nv ? s.at(c + k) : 0u;
    }
    unsigned prev = (c > 0 && c - 1 < s.nbytes) ? s.at(c - 1) : 0x100u;
    unsigned mask = 0;
#pragma unroll
    for (int k = 0; k < DF_RUN; ++k) {
        if (k < nv && b[k] != prev) mask |= 1u << k;
        prev = b[k];
    }
    return mask;
}

// Calls f(k, sym, len) for each token starting at byte c + k, in order:
// sym is the literal/length symbol (0..285), len the token's bytes. r0_in is
// the last run start before c, rend_in the first run start (or the stream's
// end, or a cap past any token's reach) at or after c + DF_RUN.
template <typename F>
__device__ __forceinline__ void df_tokens(const unsigned b[DF_RUN],
                                          unsigned smask, int nv, int c,
                                          int r0_in, int rend_in, F&& f) {
    int rend[DF_RUN];
    int re = rend_in;
#pragma unroll
    for (int k = DF_RUN - 1; k >= 0; --k) {
        rend[k] = re;
        if (smask >> k & 1) re = c + k;
    }
    int r0 = r0_in;
#pragma unroll
    for (int k = 0; k < DF_RUN; ++k) {
        if (k < nv) {
            const int i = c + k;
            if (smask >> k & 1) r0 = i;
            const int o = i - r0;
            if (o == 0) {
                f(k, (int)b[k], 1);
            } else {
                const int ph = (o - 1) % DF_MAX_MATCH;
                const int rem = rend[k] - i;
                if (ph == 0) {
                    if (rem >= 3) {
                        const int len = min(rem, DF_MAX_MATCH);
                        int code, xb, xv;
                        df_length_code(len - 3, code, xb, xv);
                        f(k, 257 + code, len);
                    } else {
                        f(k, (int)b[k], 1);
                    }
                } else if (ph == 1 && rem == 1) {
                    f(k, (int)b[k], 1);
                }
            }
        }
    }
}

// Shared state of a tile's analysis.
struct DfTileShared {
    int slot;
    int halo;
    int warp_a[DF_THREADS / 32];
    int warp_b[DF_THREADS / 32];
    int warp_c[DF_THREADS / 32];
    int warp_d[DF_THREADS / 32];
    unsigned base;
};

// The first run start in [c0 + DF_TILE, ...) within DF_HALO bytes, or the
// stream's end, or the cap c0 + DF_TILE + DF_HALO. Every thread calls it.
template <typename T>
__device__ __forceinline__ int df_halo(const DfSrc<T>& s, int c0,
                                       DfTileShared& sh) {
    const int te = c0 + DF_TILE;
    if (threadIdx.x == 0) sh.halo = min(s.nbytes, te + DF_HALO);
    __syncthreads();
    for (int t = threadIdx.x; t < DF_HALO; t += DF_THREADS) {
        const int p = te + t;
        if (p < s.nbytes && s.at(p) != s.at(p - 1)) atomicMin(&sh.halo, p);
    }
    __syncthreads();
    return sh.halo;
}

// ---------------------------------------------------------------------------
// launch 1: tokens, block counts, Adler-32 sums
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(DF_THREADS)
deflate_rle_tokens_kernel(DfSrc<T> s, DfWs ws) {
    __shared__ DfTileShared sh;
    __shared__ unsigned hist[2][DF_SYMS];
    __shared__ unsigned long long sums[2];
    const int tile = pee_take_ticket(&ws.head->ticket1, &sh.slot);
    for (int i = threadIdx.x; i < 2 * DF_SYMS; i += DF_THREADS) {
        (&hist[0][0])[i] = 0;
    }
    if (threadIdx.x < 2) sums[threadIdx.x] = 0;
    const int c0 = tile * DF_TILE;
    const int c = c0 + threadIdx.x * DF_RUN;
    unsigned b[DF_RUN];
    int nv;
    const unsigned smask = df_load_run(s, c, b, nv);

    int tile_last;
    const int my_last = smask ? c + 31 - __clz(smask) : -1;
    const int thr_left = df_block_excl_max(my_last, sh.warp_a, &tile_last);
    if (threadIdx.x < 32) {
        const unsigned e =
            df_lookback_max(ws.st_r0, tile, (unsigned)(tile_last + 1));
        if (threadIdx.x == 0) sh.base = e;
    }
    const int my_first = smask ? c + __ffs(smask) - 1 : 0x7fffffff;
    const int thr_right =
        df_block_excl_min_after(my_first, sh.warp_b, 0x7fffffff);
    const int halo = df_halo(s, c0, sh);   // barriers: sh.base visible
    const int tile_left = (int)sh.base - 1;
    const int r0_in = max(tile_left, thr_left);
    const int rend_in = min(thr_right, halo);

    int cnt = 0;
    df_tokens(b, smask, nv, c, r0_in, rend_in,
              [&](int, int, int) { ++cnt; });
    int tile_cnt;
    const int thr_off = pee_block_excl_scan<DF_THREADS>(cnt, sh.warp_c,
                                                        &tile_cnt);
    __syncthreads();
    if (threadIdx.x < 32) {
        const unsigned e = pee_lookback(ws.st_tok, tile, (unsigned)tile_cnt);
        if (threadIdx.x == 0) {
            sh.base = e;
            ws.tile_r0[tile] = tile_left;
            ws.tile_tok[tile] = (int)e;
        }
    }
    __syncthreads();
    const int tile_tok = (int)sh.base;
    const int b_base = tile_tok / DF_BLOCK_TOKENS;
    int g = tile_tok + thr_off;
    unsigned long long s1 = 0, s2 = 0;
    df_tokens(b, smask, nv, c, r0_in, rend_in, [&](int k, int sym, int len) {
        const int blk = g / DF_BLOCK_TOKENS;
        const int r = g - blk * DF_BLOCK_TOKENS;
        atomicAdd(&hist[blk - b_base][sym], 1u);
        if (len > 1) atomicAdd(&hist[blk - b_base][DF_L_CODES], 1u);
        if (r == 0) ws.blk_start[blk] = c + k;
        if (r == DF_BLOCK_TOKENS - 1) ws.blk_last[blk] = c + k;
        ++g;
    });
#pragma unroll
    for (int k = 0; k < DF_RUN; ++k) {
        s1 += b[k];
        s2 += (unsigned long long)(c - c0 + k) * b[k];
    }
    atomicAdd(&sums[0], s1);
    atomicAdd(&sums[1], s2);
    __syncthreads();
    const int nblk = (tile_tok + tile_cnt - 1) / DF_BLOCK_TOKENS - b_base + 1;
    for (int i = threadIdx.x; i < 2 * DF_SYMS; i += DF_THREADS) {
        const int slot = i / DF_SYMS;
        const unsigned v = (&hist[0][0])[i];
        if (v && slot < nblk) {
            atomicAdd(ws.hist + (size_t)(b_base + slot) * DF_SYMS + i % DF_SYMS,
                      v);
        }
    }
    if (threadIdx.x == 0) {
        const unsigned long long t1 = sums[0], t2 = sums[1];
        atomicAdd(&ws.head->adler1, t1);
        atomicAdd(&ws.head->adler2,
                  (unsigned long long)(c0 % DF_ADLER) * (t1 % DF_ADLER) +
                      t2 % DF_ADLER);
        if (c0 + DF_TILE >= s.nbytes) ws.head->ntok = tile_tok + tile_cnt;
    }
}

// ---------------------------------------------------------------------------
// launch 2: trees.c for each block, then the layout
// ---------------------------------------------------------------------------

struct DfTreeShared {
    // heap entries: freq << 40 | depth << 32 | node; past DF_HEAP_SIZE only
    // room for df_pqdownheap's look-ahead
    unsigned long long heap[DF_HEAP_SIZE + 7];
    unsigned freq[DF_HEAP_SIZE];
    unsigned short dad[DF_HEAP_SIZE];
    unsigned short len[DF_HEAP_SIZE];
    int bl_count[16];
    int heap_max, max_code, overflow;
    unsigned long long opt_len, static_len;   // two's complement sums
    unsigned short lit_len[DF_L_CODES + 1];
    unsigned short dist_len[DF_D_CODES + 1];
    unsigned short bl_len[DF_BL_CODES];
    unsigned bl_freq[DF_BL_CODES];   // scan_tree's counts, before forcing
    unsigned hist[DF_SYMS];
    unsigned codes[DF_L_CODES];
    int max_lcode, max_dcode, max_blindex, kind;
    unsigned long long sym_bits;     // the symbols' code and extra bits
    int ticket;
};

// pqdownheap, two levels per round of shared-memory loads: the children of
// k and all four grandchildren are read together (past the heap's end they
// are read and not used), then the same comparisons as zlib's pick one or
// two steps down. smaller(): freq, then depth, as one key; equal keys count
// as smaller, so ties go to the right child and leave v above.
__device__ __forceinline__ void df_pqdownheap(unsigned long long* heap, int k,
                                              int hl) {
    const unsigned long long v = heap[k];
    const unsigned long long kv = v >> 32;
    for (;;) {
        int j = k << 1;
        if (j > hl) break;
        const unsigned long long c0 = heap[j], c1 = heap[j + 1];
        const unsigned long long g0 = heap[2 * j], g1 = heap[2 * j + 1];
        const unsigned long long g2 = heap[2 * j + 2], g3 = heap[2 * j + 3];
        const bool right = j < hl && (c1 >> 32) <= (c0 >> 32);
        const unsigned long long c = right ? c1 : c0;
        j += right;
        if (kv <= (c >> 32)) break;
        heap[k] = c;
        k = j;
        int j2 = k << 1;
        if (j2 > hl) break;
        const unsigned long long d0 = right ? g2 : g0, d1 = right ? g3 : g1;
        const bool right2 = j2 < hl && (d1 >> 32) <= (d0 >> 32);
        const unsigned long long dd = right2 ? d1 : d0;
        j2 += right2;
        if (kv <= (dd >> 32)) break;
        heap[k] = dd;
        k = j2;
    }
    heap[k] = v;
}

// build_tree up to gen_bitlen, one thread: the heap of the tree of `elems`
// leaves whose counts are in t.freq[0 .. elems) (kind 0 literal/length, 1
// distance, 2 bit length), the forced second code, the merges (dad) and
// the nodes in merge order from t.heap_max up. Sets t.max_code.
__device__ __forceinline__ void df_build_heap(DfTreeShared& t, int elems,
                                              int kind) {
    unsigned long long* heap = t.heap;
    int hl = 0, max_code = -1;
    for (int n = 0; n < elems; ++n) {
        const unsigned f = t.freq[n];
        if (f) {
            heap[++hl] = (unsigned long long)f << 40 | (unsigned)n;
            max_code = n;
        } else {
            t.len[n] = 0;
        }
    }
    while (hl < 2) {
        const int node = max_code < 2 ? ++max_code : 0;
        t.freq[node] = 1;
        heap[++hl] = 1ull << 40 | (unsigned)node;
        t.opt_len -= 1;
        if (kind == 0) t.static_len -= df_static_len(node);
        if (kind == 1) t.static_len -= 5;
    }
    for (int n = hl / 2; n >= 1; --n) df_pqdownheap(heap, n, hl);
    int hmax = DF_HEAP_SIZE;
    int node = elems;
    do {
        const unsigned long long en = heap[1];
        heap[1] = heap[hl--];
        df_pqdownheap(heap, 1, hl);
        const unsigned long long em = heap[1];
        heap[--hmax] = en;
        heap[--hmax] = em;
        const unsigned long long f = (en >> 40) + (em >> 40);
        const unsigned long long dn = (en >> 32) & 0xFF, dm = (em >> 32) & 0xFF;
        t.dad[(unsigned)en] = t.dad[(unsigned)em] = (unsigned short)node;
        heap[1] = f << 40 | (max(dn, dm) + 1) << 32 | (unsigned)node;
        ++node;
        df_pqdownheap(heap, 1, hl);
    } while (hl >= 2);
    heap[--hmax] = heap[1];
    t.heap_max = hmax;
    t.max_code = max_code;
}

// gen_bitlen on all threads of the block: a node's bit length is its depth
// (its walk to the root), capped at max_length, and the cap's count is the
// overflow; the leaves' sums go in by shared atomics. Then one thread runs
// zlib's overflow repair where there is one. Leaves t.len; two barriers.
__device__ __forceinline__ void df_gen_bitlen(DfTreeShared& t, int kind) {
    const int max_length = kind == 2 ? 7 : 15;
    const int hmax = t.heap_max, max_code = t.max_code;
    const unsigned root = (unsigned)t.heap[hmax];
    for (int h = hmax + 1 + threadIdx.x; h < DF_HEAP_SIZE;
         h += DF_TREE_THREADS) {
        const unsigned n = (unsigned)t.heap[h];
        int depth = 0;
        for (unsigned x = n; x != root; x = t.dad[x]) ++depth;
        const int bits = min(depth, max_length);
        if (depth > max_length) atomicAdd(&t.overflow, 1);
        t.len[n] = (unsigned short)bits;
        if ((int)n > max_code) continue;
        atomicAdd(&t.bl_count[bits], 1);
        int xbits = 0;
        if (kind == 0 && n >= 257) xbits = df_extra_lbits((int)n);
        if (kind == 1) xbits = n < 4 ? 0 : (int)(n >> 1) - 1;
        if (kind == 2) xbits = df_extra_blbits((int)n);
        const unsigned long long f = t.freq[n];
        atomicAdd(&t.opt_len, f * (unsigned long long)(bits + xbits));
        if (kind == 0) {
            atomicAdd(&t.static_len, f * (df_static_len((int)n) + xbits));
        }
        if (kind == 1) atomicAdd(&t.static_len, f * (5ull + xbits));
    }
    if (threadIdx.x == 0) t.len[root] = 0;
    __syncthreads();
    if (threadIdx.x == 0 && t.overflow) {
        int overflow = t.overflow;
        do {
            int bits = max_length - 1;
            while (t.bl_count[bits] == 0) --bits;
            t.bl_count[bits]--;
            t.bl_count[bits + 1] += 2;
            t.bl_count[max_length]--;
            overflow -= 2;
        } while (overflow > 0);
        int h = DF_HEAP_SIZE;
        for (int bits = max_length; bits != 0; --bits) {
            int n = t.bl_count[bits];
            while (n != 0) {
                const int m = (int)(unsigned)t.heap[--h];
                if (m > max_code) continue;
                if (t.len[m] != bits) {
                    t.opt_len += (unsigned long long)(
                        ((long long)bits - t.len[m]) * t.freq[m]);
                    t.len[m] = (unsigned short)bits;
                }
                --n;
            }
        }
    }
    __syncthreads();
}

// Prepares a tree's counts (one thread), then builds it (all threads).
__device__ __forceinline__ void df_tree(DfTreeShared& t, int elems, int kind) {
    if (threadIdx.x == 0) {
        for (int b = 0; b < 16; ++b) t.bl_count[b] = 0;
        t.overflow = 0;
        df_build_heap(t, elems, kind);
    }
    __syncthreads();
    df_gen_bitlen(t, kind);
}

// gen_codes over lens[0 .. max_code]: len << 16 | bit-reversed code.
__device__ void df_gen_codes(const unsigned short* lens, int max_code,
                             unsigned* out) {
    int count[16] = {0};
    for (int n = 0; n <= max_code; ++n) count[lens[n]]++;
    unsigned next[16];
    unsigned code = 0;
    for (int bits = 1; bits <= 15; ++bits) {
        code = (code + (bits > 1 ? count[bits - 1] : 0)) << 1;
        next[bits] = code;
    }
    for (int n = 0; n <= max_code; ++n) {
        const int l = lens[n];
        out[n] = l ? (unsigned)l << 16 | df_rev(next[l]++, l) : 0u;
    }
}

// scan_tree and send_tree in one: for each bit length code the tree sends,
// f(code, extra value, extra bits).
template <typename F>
__device__ void df_walk_tree(const unsigned short* lens, int max_code, F&& f) {
    int prevlen = -1, nextlen = lens[0], count = 0;
    int max_count = 7, min_count = 4;
    if (nextlen == 0) max_count = 138, min_count = 3;
    for (int n = 0; n <= max_code; ++n) {
        const int curlen = nextlen;
        nextlen = n + 1 <= max_code ? lens[n + 1] : 0xffff;   // the guard
        if (++count < max_count && curlen == nextlen) continue;
        if (count < min_count) {
            do f(curlen, 0, 0); while (--count != 0);
        } else if (curlen != 0) {
            if (curlen != prevlen) f(curlen, 0, 0), --count;
            f(16, count - 3, 2);
        } else if (count <= 10) {
            f(17, count - 3, 3);
        } else {
            f(18, count - 11, 7);
        }
        count = 0;
        prevlen = curlen;
        if (nextlen == 0) max_count = 138, min_count = 3;
        else if (curlen == nextlen) max_count = 6, min_count = 3;
        else max_count = 7, min_count = 4;
    }
}

__constant__ unsigned char df_bl_order[DF_BL_CODES] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

// How many times zlib's window has slid when the token at x is decided
// (x == n: the end of the input), for n bytes given to one deflate call:
// ops/deflate_rle.py slides_by, in closed form.
__device__ __forceinline__ int df_slides_by(long long x, long long n) {
    // slides while more input waits behind the window
    const long long ja = max(0LL, (n - 1) / 32768 - 1);
    const long long a = min(ja, max(0LL, (x + DF_MAX_MATCH) / 32768 - 1));
    if (a < ja) return (int)a;
    const long long edge = 32768LL * (ja + 2);
    const long long th = max(n - DF_MAX_MATCH, edge - 262);
    return (int)(th <= x ? a + 1 : a);
}

__global__ void __launch_bounds__(DF_TREE_THREADS)
deflate_rle_trees_kernel(int nbytes, int nbmax, DfWs ws) {
    __shared__ DfTreeShared t;
    const int ntok = ws.head->ntok;
    const int nb = ntok / DF_BLOCK_TOKENS + 1;
    const int b = blockIdx.x;
    if (b < nb) {
        for (int i = threadIdx.x; i < DF_SYMS; i += DF_TREE_THREADS) {
            t.hist[i] = ws.hist[(size_t)b * DF_SYMS + i];
        }
        __syncthreads();
        const int start = b * DF_BLOCK_TOKENS < ntok ? ws.blk_start[b] : nbytes;
        const int end = (b + 1) * DF_BLOCK_TOKENS < ntok ? ws.blk_start[b + 1]
                                                         : nbytes;
        const int last = b == nb - 1;
        if (threadIdx.x == 0) {
            t.opt_len = t.static_len = 0;
            // literal/length tree (with the end code)
            for (int n = 0; n < DF_L_CODES; ++n) t.freq[n] = t.hist[n];
            t.freq[256] = 1;
        }
        __syncthreads();
        df_tree(t, DF_L_CODES, 0);
        if (threadIdx.x == 0) {
            t.max_lcode = t.max_code;
            for (int n = 0; n < DF_L_CODES; ++n) t.lit_len[n] = t.len[n];
            for (int n = 0; n < DF_D_CODES; ++n) t.freq[n] = 0;
            t.freq[0] = t.hist[DF_L_CODES];
        }
        __syncthreads();
        df_tree(t, DF_D_CODES, 1);   // the distance tree
        if (threadIdx.x == 0) {
            t.max_dcode = t.max_code;
            for (int n = 0; n < DF_D_CODES; ++n) t.dist_len[n] = t.len[n];
            // the bit length tree (build_bl_tree)
            for (int n = 0; n < DF_BL_CODES; ++n) t.bl_freq[n] = 0;
            auto count = [&](int code, int, int) { t.bl_freq[code]++; };
            df_walk_tree(t.lit_len, t.max_lcode, count);
            df_walk_tree(t.dist_len, t.max_dcode, count);
            for (int n = 0; n < DF_BL_CODES; ++n) t.freq[n] = t.bl_freq[n];
        }
        __syncthreads();
        df_tree(t, DF_BL_CODES, 2);
        if (threadIdx.x == 0) {
            for (int n = 0; n < DF_BL_CODES; ++n) t.bl_len[n] = t.len[n];
            int mbi = DF_BL_CODES - 1;
            while (mbi >= 3 && t.bl_len[df_bl_order[mbi]] == 0) --mbi;
            t.max_blindex = mbi;
            t.opt_len += 3 * (mbi + 1) + 5 + 5 + 4;
            // _tr_flush_block's choice
            const long long x = last ? nbytes : ws.blk_last[b];
            const bool stored_ok =
                (long long)start >= 32768LL * df_slides_by(x, nbytes);
            long long opt_lenb = ((long long)t.opt_len + 3 + 7) >> 3;
            const long long static_lenb =
                ((long long)t.static_len + 3 + 7) >> 3;
            if (static_lenb <= opt_lenb) opt_lenb = static_lenb;
            if ((long long)(end - start) + 4 <= opt_lenb && stored_ok) {
                t.kind = 0;
            } else {
                t.kind = static_lenb == opt_lenb ? 1 : 2;
            }
            if (t.kind == 2) df_gen_codes(t.lit_len, t.max_lcode, t.codes);
            t.sym_bits = 0;
        }
        __syncthreads();
        // the block's tables and bit counts
        const int kind = t.kind;
        DfBlock* blk = ws.blocks + b;
        unsigned* lit = ws.lit + (size_t)b * DF_L_CODES;
        unsigned long long data = 0;
        for (int n = threadIdx.x; n < DF_L_CODES; n += DF_TREE_THREADS) {
            unsigned e = 0;
            if (kind == 1) e = df_static_lit(n);
            if (kind == 2) e = n <= t.max_lcode ? t.codes[n] : 0u;
            lit[n] = e;
            if (n != 256 && t.hist[n]) {
                data += (unsigned long long)t.hist[n] *
                        ((e >> 16) + (n > 256 ? df_extra_lbits(n) : 0));
            }
        }
        atomicAdd(&t.sym_bits, data);
        __syncthreads();
        if (threadIdx.x == 0) {
            unsigned dcodes[DF_D_CODES];
            df_gen_codes(t.dist_len, t.max_dcode, dcodes);
            unsigned bl[DF_BL_CODES];
            df_gen_codes(t.bl_len, DF_BL_CODES - 1, bl);
            blk->kind = kind;
            blk->last = last;
            blk->start = start;
            blk->stored_len = end - start;
            blk->max_lcode = t.max_lcode;
            blk->max_dcode = t.max_dcode;
            blk->max_blindex = t.max_blindex;
            const unsigned eob = kind == 1 ? df_static_lit(256)
                                           : kind == 2 ? t.codes[256] : 0u;
            const unsigned dist0 = kind == 1 ? (5u << 16)
                                             : kind == 2 ? dcodes[0] : 0u;
            blk->eob = eob;
            blk->dist0 = dist0;
            unsigned hdr = 3;
            if (kind == 2) {
                unsigned long long tree = 0;
                for (int n = 0; n < DF_BL_CODES; ++n) {
                    tree += (unsigned long long)t.bl_freq[n] *
                            (t.bl_len[n] + df_extra_blbits(n));
                }
                hdr += 14 + 3 * (t.max_blindex + 1) + (unsigned)tree;
            }
            const unsigned long long tok =
                t.sym_bits +
                (unsigned long long)t.hist[DF_L_CODES] * (dist0 >> 16);
            blk->hdr_bits = hdr;
            blk->data_bits = kind ? (unsigned)(tok + (eob >> 16)) : 0u;
            blk->tok_bits = kind ? (unsigned)tok : 8u * (unsigned)(end - start);
            for (int n = 0; n < DF_BL_CODES; ++n) blk->bl[n] = bl[n];
            for (int n = 0; n < DF_D_CODES; ++n) {
                blk->dist_len[n] = (unsigned char)t.dist_len[n];
            }
        }
    }
    // the last block to finish lays the deflate blocks out, DF_LAYOUT at a
    // time: their sizes into shared memory, one thread's pass, the offsets
    // back
    __shared__ unsigned l_kind[DF_LAYOUT], l_a[DF_LAYOUT], l_b[DF_LAYOUT],
        l_t[DF_LAYOUT];
    __shared__ unsigned long long l_hdr[DF_LAYOUT], l_data[DF_LAYOUT],
        l_pf[DF_LAYOUT];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) t.ticket = (int)atomicAdd(&ws.head->done2, 1u);
    __syncthreads();
    if (t.ticket != nbmax - 1) return;
    __threadfence();
    unsigned long long bit = 0, pfirst = 0;   // thread 0's
    for (int i0 = 0; i0 < nb; i0 += DF_LAYOUT) {
        const int m = min(DF_LAYOUT, nb - i0);
        for (int j = threadIdx.x; j < m; j += DF_TREE_THREADS) {
            const DfBlock* blk = ws.blocks + i0 + j;
            const int kind = __ldcg(&blk->kind);
            l_kind[j] = (unsigned)kind;
            l_a[j] = kind ? __ldcg(&blk->hdr_bits)
                          : (unsigned)__ldcg(&blk->stored_len);
            l_b[j] = __ldcg(&blk->data_bits);
            l_t[j] = __ldcg(&blk->tok_bits);
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int j = 0; j < m; ++j) {
                l_hdr[j] = bit;
                if (l_kind[j] == 0) {   // 3-bit header, to a byte, LEN, NLEN
                    bit = ((bit + 3 + 7) & ~7ull) + 32;
                    l_data[j] = bit;
                    bit += 8ull * l_a[j];
                } else {
                    bit += l_a[j];
                    l_data[j] = bit;
                    bit += l_b[j];
                }
                l_pf[j] = pfirst;
                pfirst += l_t[j];
            }
        }
        __syncthreads();
        for (int j = threadIdx.x; j < m; j += DF_TREE_THREADS) {
            DfBlock* blk = ws.blocks + i0 + j;
            blk->hdr_bit = l_hdr[j];
            blk->data_bit = l_data[j];
            blk->pfirst = l_pf[j];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        ws.head->total_bits = bit;
        ws.head->out_len = DF_OUT_BASE + (long long)((bit + 7) >> 3) + 4;
    }
}

// ---------------------------------------------------------------------------
// launch 3: the bits
// ---------------------------------------------------------------------------

template <typename T>
__device__ void df_emit_tile(const DfSrc<T>& s, const DfWs& ws,
                             unsigned* out) {
    __shared__ DfTileShared sh;
    __shared__ unsigned lit[2][DF_L_CODES];
    __shared__ DfBlock blk[2];
    const int tile = pee_take_ticket(&ws.head->ticket3, &sh.slot);
    const int c0 = tile * DF_TILE;
    const int c = c0 + threadIdx.x * DF_RUN;
    const int ntok = ws.head->ntok;
    const int nb = ntok / DF_BLOCK_TOKENS + 1;
    const int tile_tok = ws.tile_tok[tile];
    const int b_base = tile_tok / DF_BLOCK_TOKENS;
    for (int i = threadIdx.x; i < 2 * DF_L_CODES; i += DF_THREADS) {
        const int bb = b_base + i / DF_L_CODES;
        (&lit[0][0])[i] =
            bb < nb ? ws.lit[(size_t)bb * DF_L_CODES + i % DF_L_CODES] : 0u;
    }
    if (threadIdx.x < 2 && b_base + (int)threadIdx.x < nb) {
        blk[threadIdx.x] = ws.blocks[b_base + threadIdx.x];
    }
    unsigned b[DF_RUN];
    int nv;
    const unsigned smask = df_load_run(s, c, b, nv);
    int tile_last;
    const int my_last = smask ? c + 31 - __clz(smask) : -1;
    const int thr_left = df_block_excl_max(my_last, sh.warp_a, &tile_last);
    const int my_first = smask ? c + __ffs(smask) - 1 : 0x7fffffff;
    const int thr_right =
        df_block_excl_min_after(my_first, sh.warp_b, 0x7fffffff);
    const int halo = df_halo(s, c0, sh);
    const int r0_in = max(ws.tile_r0[tile], thr_left);
    const int rend_in = min(thr_right, halo);

    // each token's bits: its code, extra length bits and distance code in
    // a Huffman block, its bytes in a stored one
    auto token_bits = [&](int g, int sym, int len) -> unsigned {
        const DfBlock& bk = blk[g / DF_BLOCK_TOKENS - b_base];
        if (bk.kind == 0) return 8u * (unsigned)len;
        const unsigned e = lit[g / DF_BLOCK_TOKENS - b_base][sym];
        if (len == 1) return e >> 16;
        return (e >> 16) + (unsigned)df_extra_lbits(sym) + (bk.dist0 >> 16);
    };
    int cnt = 0;
    df_tokens(b, smask, nv, c, r0_in, rend_in,
              [&](int, int, int) { ++cnt; });
    int tile_cnt;
    const int thr_tok = pee_block_excl_scan<DF_THREADS>(cnt, sh.warp_c,
                                                        &tile_cnt);
    int g = tile_tok + thr_tok;
    unsigned nbits = 0;
    df_tokens(b, smask, nv, c, r0_in, rend_in, [&](int, int sym, int len) {
        nbits += token_bits(g++, sym, len);
    });
    int tile_bits;
    const int thr_bits = pee_block_excl_scan<DF_THREADS>((int)nbits, sh.warp_d,
                                                         &tile_bits);
    __syncthreads();
    if (threadIdx.x < 32) {
        const unsigned e = pee_lookback(ws.st_bits, tile, (unsigned)tile_bits);
        if (threadIdx.x == 0) sh.base = e;
    }
    __syncthreads();
    unsigned p = sh.base + (unsigned)thr_bits;   // token bits before mine
    g = tile_tok + thr_tok;
    DfBits w{out, 0, 0, 0};
    int cur = -1;   // the deflate block w is writing in
    df_tokens(b, smask, nv, c, r0_in, rend_in, [&](int k, int sym, int len) {
        const int slot = g / DF_BLOCK_TOKENS - b_base;
        const DfBlock& bk = blk[slot];
        const unsigned tb = token_bits(g, sym, len);
        if (bk.kind != 0) {
            if (slot != cur) {
                w.flush();
                w.start(8ull * DF_OUT_BASE + bk.data_bit + (p - bk.pfirst));
                cur = slot;
            }
            const unsigned e = lit[slot][sym];
            if (len == 1) {
                w.put(e & 0xFFFFu, (int)(e >> 16));
            } else {
                int code, xb, xv;
                df_length_code(len - 3, code, xb, xv);
                w.put((e & 0xFFFFu) | (unsigned)xv << (e >> 16),
                      (int)(e >> 16) + xb);
                w.put(bk.dist0 & 0xFFFFu, (int)(bk.dist0 >> 16));
            }
        }
        p += tb;
        ++g;
    });
    w.flush();
}

// One deflate block's header, trees, end code and stored bytes; the last
// block also the SDFL and zlib headers and the Adler-32 trailer.
template <typename T>
__device__ void df_emit_block(const DfSrc<T>& s, const DfWs& ws, int bi,
                              unsigned* out, int code, int h, int w) {
    const DfBlock& bk = ws.blocks[bi];
    const unsigned long long base = 8ull * DF_OUT_BASE;
    if (threadIdx.x == 0) {
        DfBits wr{out, 0, 0, 0};
        wr.start(base + bk.hdr_bit);
        wr.put((unsigned)(bk.kind << 1 | bk.last), 3);
        if (bk.kind == 2) {
            wr.put((unsigned)(bk.max_lcode + 1 - 257), 5);
            wr.put((unsigned)bk.max_dcode, 5);
            wr.put((unsigned)(bk.max_blindex + 1 - 4), 4);
            for (int r = 0; r <= bk.max_blindex; ++r) {
                wr.put(bk.bl[df_bl_order[r]] >> 16, 3);
            }
            auto send = [&](int c, int xv, int xb) {
                const unsigned e = bk.bl[c];
                wr.put(e & 0xFFFFu, (int)(e >> 16));
                if (xb) wr.put((unsigned)xv, xb);
            };
            unsigned short lens[DF_L_CODES];
            const unsigned* lit = ws.lit + (size_t)bi * DF_L_CODES;
            for (int n = 0; n <= bk.max_lcode; ++n) lens[n] = lit[n] >> 16;
            df_walk_tree(lens, bk.max_lcode, send);
            for (int n = 0; n <= bk.max_dcode; ++n) lens[n] = bk.dist_len[n];
            df_walk_tree(lens, bk.max_dcode, send);
        }
        wr.flush();
        if (bk.kind != 0) {
            wr.start(base + bk.data_bit + bk.data_bits - (bk.eob >> 16));
            wr.put(bk.eob & 0xFFFFu, (int)(bk.eob >> 16));
            wr.flush();
        } else {
            const long long at = (long long)((base + bk.data_bit) >> 3) - 4;
            const unsigned len = (unsigned)bk.stored_len & 0xFFFFu;
            df_or_byte(out, at, len);
            df_or_byte(out, at + 1, len >> 8);
            df_or_byte(out, at + 2, ~len);
            df_or_byte(out, at + 3, ~len >> 8);
        }
        if (bk.last) {
            const DfHead* head = ws.head;
            const unsigned char magic[4] = {'S', 'D', 'F', 'L'};
            for (int i = 0; i < 4; ++i) df_or_byte(out, i, magic[i]);
            df_or_byte(out, 4, (unsigned)code);
            for (int i = 0; i < 4; ++i) {
                df_or_byte(out, 5 + i, (unsigned)h >> (24 - 8 * i));
                df_or_byte(out, 9 + i, (unsigned)w >> (24 - 8 * i));
            }
            df_or_byte(out, 13, 0x78);
            df_or_byte(out, 14, 0x01);
            const unsigned long long n = (unsigned long long)s.nbytes;
            const unsigned long long nm = n % DF_ADLER;
            const unsigned a = (unsigned)((1 + head->adler1) % DF_ADLER);
            const unsigned bsum = (unsigned)(
                (nm + nm * (head->adler1 % DF_ADLER) + DF_ADLER -
                 head->adler2 % DF_ADLER) % DF_ADLER);
            const unsigned adler = bsum << 16 | a;
            const long long at =
                DF_OUT_BASE + (long long)((head->total_bits + 7) >> 3);
            for (int i = 0; i < 4; ++i) {
                df_or_byte(out, at + i, adler >> (24 - 8 * i));
            }
        }
    }
    if (bk.kind == 0) {
        // the stored bytes, a word of the output at a time
        const long long ob = (long long)((base + bk.data_bit) >> 3);
        const long long w0 = ob >> 2, w1 = (ob + bk.stored_len + 3) >> 2;
        for (long long wi = w0 + threadIdx.x; wi < w1; wi += DF_THREADS) {
            unsigned v = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const long long q = 4 * wi + j - ob;
                if (q >= 0 && q < bk.stored_len) {
                    v |= s.at(bk.start + (int)q) << (8 * j);
                }
            }
            if (v) atomicOr(out + wi, v);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(DF_THREADS)
deflate_rle_emit_kernel(DfSrc<T> s, DfWs ws, int tiles, unsigned* out,
                        int code, int h, int w) {
    if ((int)blockIdx.x < tiles) {
        df_emit_tile(s, ws, out);
        return;
    }
    const int bi = (int)blockIdx.x - tiles;
    if (bi < ws.head->ntok / DF_BLOCK_TOKENS + 1) {
        df_emit_block(s, ws, bi, out, code, h, w);
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static long long df_tiles(long long nbytes) {
    return (nbytes + DF_TILE - 1) / DF_TILE;
}

static long long df_nbmax(long long nbytes) {
    return nbytes / DF_BLOCK_TOKENS + 2;
}

static long long df_align(long long v) { return (v + 255) & ~255LL; }

// Carves the workspace (zeroed by the launcher) into its arrays; returns
// its size in bytes.
static long long df_layout(long long nbytes, char* base, DfWs* ws) {
    const long long tiles = df_tiles(nbytes), nbmax = df_nbmax(nbytes);
    long long off = 0;
    auto take = [&](long long bytes) {
        char* p = base ? base + off : nullptr;
        off += df_align(bytes);
        return p;
    };
    DfWs w;
    w.head = (DfHead*)take(sizeof(DfHead));
    w.st_r0 = (unsigned long long*)take(8 * tiles);
    w.st_tok = (unsigned long long*)take(8 * tiles);
    w.st_bits = (unsigned long long*)take(8 * tiles);
    w.tile_r0 = (int*)take(4 * tiles);
    w.tile_tok = (int*)take(4 * tiles);
    w.hist = (unsigned*)take(4 * nbmax * DF_SYMS);
    w.blk_start = (int*)take(4 * nbmax);
    w.blk_last = (int*)take(4 * nbmax);
    w.blocks = (DfBlock*)take(sizeof(DfBlock) * nbmax);
    w.lit = (unsigned*)take(4 * nbmax * DF_L_CODES);
    if (ws) *ws = w;
    return off;
}

template <typename T>
static int launch_deflate_rle(const void* px, long long n_px, int h, int w,
                              void* buf, long long buf_bytes, void* stream) {
    const long long nbytes = n_px * (long long)sizeof(T);
    if (!px || !buf || n_px < 1 || nbytes > DF_MAX_STREAM) {
        return (int)cudaErrorInvalidValue;
    }
    DfWs ws;
    const long long ws_bytes = df_layout(nbytes, (char*)buf, &ws);
    const long long cap = nbytes + (nbytes >> 3) + 16 * df_nbmax(nbytes) + 64;
    if (buf_bytes < ws_bytes + cap) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(buf, 0, (size_t)(ws_bytes + cap), st);
    if (err != cudaSuccess) return (int)err;
    const DfSrc<T> src{(const T*)px, (int)n_px, (int)nbytes};
    const int tiles = (int)df_tiles(nbytes), nbmax = (int)df_nbmax(nbytes);
    deflate_rle_tokens_kernel<T><<<tiles, DF_THREADS, 0, st>>>(src, ws);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    deflate_rle_trees_kernel<<<nbmax, DF_TREE_THREADS, 0, st>>>(
        (int)nbytes, nbmax, ws);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int code = sizeof(T) == 1 ? 1 : 3;
    deflate_rle_emit_kernel<T><<<tiles + nbmax, DF_THREADS, 0, st>>>(
        src, ws, tiles, (unsigned*)((char*)buf + ws_bytes), code, h, w);
    return (int)cudaGetLastError();
}

extern "C" {

// Bytes of the buffer a launch takes for an image of n_px pixels of
// `itemsize` bytes: the workspace (its first int64 is the result's length
// once the launches are done), then the result (at deflate_rle_out_offset).
long long deflate_rle_buffer_bytes(long long n_px, int itemsize) {
    const long long nbytes = n_px * itemsize;
    return df_layout(nbytes, nullptr, nullptr) + nbytes + (nbytes >> 3) +
           16 * df_nbmax(nbytes) + 64;
}

long long deflate_rle_out_offset(long long n_px, int itemsize) {
    return df_layout(n_px * itemsize, nullptr, nullptr);
}

long long deflate_rle_max_stream(void) { return DF_MAX_STREAM; }

int deflate_rle_u8(const void* px, long long n_px, int h, int w, void* buf,
                   long long buf_bytes, void* stream) {
    return launch_deflate_rle<uint8_t>(px, n_px, h, w, buf, buf_bytes, stream);
}

int deflate_rle_u16(const void* px, long long n_px, int h, int w, void* buf,
                    long long buf_bytes, void* stream) {
    return launch_deflate_rle<uint16_t>(px, n_px, h, w, buf, buf_bytes,
                                        stream);
}

}  // extern "C"
