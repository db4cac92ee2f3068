// The deflate codec's decode of one stego on the card: the inflate of the
// zlib stream that follows the codec's 13-byte SDFL header, straight into
// the image (SDFL code 3: byte i < n is pixel i's low byte, byte i >= n the
// high byte of pixel i - n; code 1: byte i is pixel i).
//
// Replaces no TPU kernel: the JAX package inflates on the host, and so did
// the port, on one host thread, before it uploaded the stego for K2 or K4.
// Its plain version, and the spec of every stage below, is
// tests/torch_inflate_plain.py (`inflate_plain`); the route is
// codec_tcc_tpu_torch/ops/inflate.py.
//
// Every stream the codec writes is zlib level 1 with Z_RLE, whose matches
// are all at distance 1. A block then depends on the blocks before it only
// through the bit where it starts and the last byte they wrote, and the
// starts of the dynamic blocks can be found without decoding what comes
// before them: every bit offset is tested for a dynamic header that is
// whole (speculative parallel inflate, as rapidgzip does on a CPU).
//
// Bound: neither bytes nor operations. 2048x2048 uint16: ~5.3 MB read and
// 8.4 MB written, ~4 us at 3.35 TB/s. What holds the kernels back is that a
// Huffman code is decoded one symbol after the other: one thread decoding a
// block's ~32,767 symbols takes ~4 ms. So each block is cut into chunks of
// INF_CHUNK bits, one a thread, each decoded from each of its first
// INF_STARTS bits (a decode that passes through another of those bits
// serves it too); the one true start of each chunk is where the chunk
// before it ends, which a scan over the threads' start maps finds. Codes of
// nearly one length (a noisy low-byte plane: 8 bits for every literal) never
// fall back into step from a wrong start, so a chunk is decoded about once
// for each bit of a symbol, and the starts phase sets the time.
//
// Launches, after one memset of the workspace:
//   1. inflate_scan: every bit offset, 32 a thread from a window of
//      registers, is tested for a dynamic header: BTYPE 10, HLIT <= 29,
//      HDIST <= 29 and a complete code length code there; the few that pass
//      go to a queue that the block's threads then take through the rest
//      (code lengths that repeat nothing before the first and run past no
//      end, complete literal/length and distance codes with a non-zero end
//      code). The offsets that pass go to a candidate list and a hash,
//      up to the cap (inf_cap) that the measure's grid takes.
//   2. inflate_measure: one block of INF_CTA threads per candidate builds
//      its tables in shared memory, decodes window after window of chunks
//      to the end code without writing, and records each chunk's true start
//      and output offset: end bit, output length, last literal, whether a
//      match comes before any literal, whether a distance other than 1 or
//      a broken code came up.
//   3. inflate_chain: one block walks the blocks from bit 16, after the
//      zlib header: stored blocks from LEN/NLEN, dynamic blocks from the
//      candidate that starts exactly there, fixed blocks (and dynamic ones
//      whose candidate is missing or failed) decoded on the walk itself.
//      It lays out the output offsets, resolves each block's predecessor
//      byte, and checks BFINAL, the exact length and the trailer's place;
//      it leaves the status word. The blocks past the emit's grid
//      (inf_chain_cap) it emits itself, so no stream is too long for the
//      caps: a stream past them is slower, not refused.
//   4. inflate_emit: one block per chain block stores its bytes, each
//      thread a chunk from its recorded start (a stored block: a byte a
//      thread at a time), summing Adler-32 on the way; the last block to
//      finish compares it with the trailer.
//
// The routines above the kernels use no CUDA built-in outside INF_ macros,
// so a host compiler builds them too (every thread of a block in turn, the
// tables by one lane), to check them against zlib where no card is.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define INF_FN __device__ __forceinline__
#define INF_CONST __constant__
#define INF_SYNC() __syncwarp()
#else
#define INF_FN static inline
#define INF_CONST static const
#define INF_SYNC() ((void)0)
#endif
#include <stdint.h>

#define INF_ROOT_LIT 10            // root table bits, literal/length code
#define INF_ROOT_DIST 8            // root table bits, distance code
#define INF_SCAN_THREADS 256
#define INF_SCAN_QUEUE 2048        // offsets a scan block defers
#define INF_MAX_TOKENS 65536       // a candidate's symbols before it fails
// The sizes below may be set smaller for a host build (the CPU tests run
// the routines with a few threads, short chunks and starts, and one window
// of records, to reach every path).
#ifndef INF_CTA
#define INF_CTA 1024               // threads of a measure, chain, emit block
#endif
#ifndef INF_CHUNK
#define INF_CHUNK 256              // bits a thread starts in, a window
#endif
#ifndef INF_STARTS
#define INF_STARTS 16              // first bits of a chunk decoded from
#endif
#ifndef INF_WINDOWS
#define INF_WINDOWS 8              // windows of records a candidate keeps
#endif
// Candidates the measure takes: INF_CAP_MIN + a stream byte in
// INF_CAP_PER (every zlib block but the last holds thousands of symbols).
// Past that, the chain decodes the blocks of the candidates left out
// itself. Chain blocks the emit takes: INF_CHAIN_MIN + an output byte in
// INF_CHAIN_PER; the chain emits the blocks past that itself.
#ifndef INF_CAP_MIN
#define INF_CAP_MIN 256
#endif
#ifndef INF_CAP_PER
#define INF_CAP_PER 2048
#endif
#ifndef INF_CHAIN_MIN
#define INF_CHAIN_MIN 64
#endif
#ifndef INF_CHAIN_PER
#define INF_CHAIN_PER 2048
#endif
#define INF_MAX_STREAM ((1 << 28) - 1)

// status word (ops/inflate.py STATUS). INF_FOREIGN marks a stream that zlib
// may decode and the kernels do not: a distance other than 1, or a Huffman
// code that zlib takes incomplete (one 1-bit code, or no distance code).
// The other faults mark a stream that zlib refuses too.
#define INF_OK 0
#define INF_BROKEN 2
#define INF_FOREIGN 3
#define INF_LENGTH 4
#define INF_ADLER 5

// flags of a decoded block
#define INF_OPENS 1                // a match comes before any literal
#define INF_FAR 2                  // a distance other than 1
#define INF_BAD 4                  // no valid decode

#define INF_ADLER_BASE 65521u

INF_CONST unsigned short inf_len_base[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
    67, 83, 99, 115, 131, 163, 195, 227, 258};
INF_CONST unsigned char inf_len_extra[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
    5, 5, 5, 5, 0};
INF_CONST unsigned char inf_dist_extra[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
    11, 11, 12, 12, 13, 13};

// Read by the host once the launches are done.
struct InfHead {
    int status;
    int ncand;                     // offsets that passed (may pass the cap)
    int nblocks;                   // chain blocks
    int nserial;                   // chain blocks no candidate covered
    long long total;               // bytes the chain gives
    unsigned trailer;              // the stream's Adler-32
    unsigned done;                 // emit tickets
    unsigned long long s1, s2;     // sum b, sum i * b over the output
    int nwin;                      // windows of records taken
};

// A candidate as the measure leaves it, with the windows of its records:
// nwin < 0 where they did not fit (the emit then finds the chunks' starts
// itself).
struct InfCand {
    unsigned start, end;
    int out_len, last, flags;
    int nwin;
    int win[INF_WINDOWS];
};

// A window the measure walked, and each of its chunks: the true first bit,
// the first output byte from the window's, the byte before it (-1 where
// no literal came before it in the block).
struct InfWin {
    unsigned pos0;
    int nlanes;
    long long wbase;
};

struct InfRec {
    unsigned start;
    int off, prev;
};

struct InfBlock {
    unsigned start;                // header bit
    int type;                      // BTYPE: 0 stored, 1 fixed, 2 dynamic
    int out_off, out_len;
    int prev;                      // the byte before the block, or -1
    int src;                       // stored: first data byte of the stream
    int cand;                      // the measured candidate, or -1
};

struct InfWs {
    InfHead* head;
    InfCand* cand;
    unsigned* hkey;                // offset + 1, 0 where empty
    int* hval;                     // candidate index
    InfBlock* blocks;
    InfWin* wins;
    InfRec* recs;                  // INF_CTA a window
    int cap, hmask, chain_cap, win_cap;
};

struct InfStream {
    const unsigned* words;         // little-endian words, zeros after
    long long nwords;
    unsigned nbits;
    unsigned nbytes;
};

struct InfOut {
    unsigned char* px;             // the image's bytes
    long long n_px;
    int itemsize;
};

INF_FN unsigned inf_word(const InfStream& s, long long i) {
    if (i >= s.nwords) return 0u;
#ifdef __CUDACC__
    return __ldg(s.words + i);
#else
    return s.words[i];
#endif
}

INF_FN unsigned inf_byte(const InfStream& s, long long i) {
    return (inf_word(s, i >> 2) >> (8 * (i & 3))) & 0xFFu;
}

INF_FN unsigned inf_rev(unsigned v, int len) {
#ifdef __CUDACC__
    return __brev(v) >> (32 - len);
#else
    unsigned r = 0;
    for (int i = 0; i < len; ++i) r |= ((v >> i) & 1u) << (len - 1 - i);
    return r;
#endif
}

// LSB-first bits. After inf_start or inf_fill at least 33 bits are held, so
// a caller that fills before each group of at most 32 bits never runs dry.
struct InfReader {
    unsigned long long buf;
    int have;
    long long next;
    unsigned pos;
};

INF_FN void inf_start(InfReader& r, const InfStream& s, unsigned pos) {
    r.next = pos >> 5;
    r.buf = inf_word(s, r.next++) >> (pos & 31);
    r.have = 32 - (int)(pos & 31);
    r.buf |= (unsigned long long)inf_word(s, r.next++) << r.have;
    r.have += 32;
    r.pos = pos;
}

INF_FN void inf_fill(InfReader& r, const InfStream& s) {
    if (r.have <= 32) {
        r.buf |= (unsigned long long)inf_word(s, r.next++) << r.have;
        r.have += 32;
    }
}

INF_FN unsigned inf_peek(const InfReader& r, int n) {
    return (unsigned)(r.buf & ((1ull << n) - 1));
}

INF_FN void inf_skip(InfReader& r, int n) {
    r.buf >>= n;
    r.have -= n;
    r.pos += n;
}

INF_FN unsigned inf_take(InfReader& r, int n) {
    const unsigned v = inf_peek(r, n);
    inf_skip(r, n);
    return v;
}

// the order in which a dynamic header sends the code length code's lengths
// (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
INF_FN int inf_order(int i) {
    if (i < 3) return 16 + i;
    const int j = i - 3;
    return j == 0 ? 0 : (j & 1) ? 8 + (j >> 1) : 8 - (j >> 1);
}

// A canonical code: a root table of `root` bits (symbol << 4 | length, 0
// where the code is longer), and the counts and sorted symbols that
// decode the longer ones bit by bit.
template <int ROOT, int NSYM>
struct InfCode {
    unsigned short root[1 << ROOT];
    unsigned short count[16];
    unsigned short sorted[NSYM];
};

// One warp's tables, in shared memory on the card.
struct InfWarp {
    InfCode<INF_ROOT_LIT, 288> lit;
    InfCode<INF_ROOT_DIST, 32> dist;
    unsigned short codes[288];
    unsigned short next[16], offs[16];
    unsigned char lens[320];
    unsigned char cl[128];         // code length code: symbol | length << 5
};

// Builds `c` from the code lengths `lens[0..n)`, which form a complete
// code (the caller checked).
template <int ROOT, int NSYM>
INF_FN void inf_build(InfCode<ROOT, NSYM>& c, const unsigned char* lens,
                      int n, InfWarp& w, int lane, int nl) {
    for (int l = lane; l < 16; l += nl) {
        int k = 0;
        for (int i = 0; i < n; ++i) k += lens[i] == l;
        c.count[l] = (unsigned short)(l ? k : 0);
    }
    INF_SYNC();
    if (lane == 0) {
        int code = 0, idx = 0;
        for (int l = 1; l < 16; ++l) {
            code = (code + c.count[l - 1]) << 1;
            w.next[l] = (unsigned short)code;
            w.offs[l] = (unsigned short)idx;
            idx += c.count[l];
        }
        for (int i = 0; i < n; ++i) {
            const int l = lens[i];
            if (l) {
                w.codes[i] = w.next[l]++;
                c.sorted[w.offs[l]++] = (unsigned short)i;
            }
        }
    }
    for (int f = lane; f < (1 << ROOT); f += nl) c.root[f] = 0;
    INF_SYNC();
    for (int i = lane; i < n; i += nl) {
        const int l = lens[i];
        if (l && l <= ROOT) {
            const unsigned short e = (unsigned short)(i << 4 | l);
            for (unsigned f = inf_rev(w.codes[i], l); f < (1u << ROOT);
                 f += 1u << l) {
                c.root[f] = e;
            }
        }
    }
    INF_SYNC();
}

// The next symbol of `c` at the reader (filled), or -1; consumes its bits.
template <int ROOT, int NSYM>
INF_FN int inf_symbol(const InfCode<ROOT, NSYM>& c, InfReader& r) {
    const unsigned e = c.root[inf_peek(r, ROOT)];
    if (e & 15) {
        inf_skip(r, (int)(e & 15));
        return (int)(e >> 4);
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= 15; ++l) {
        code |= (int)(r.buf >> (l - 1)) & 1;
        const int cnt = c.count[l];
        if (code - cnt < first) {
            inf_skip(r, l);
            return c.sorted[index + (code - first)];
        }
        index += cnt;
        first = (first + cnt) << 1;
        code <<= 1;
    }
    return -1;
}

// The dynamic header whose 3-bit block header is at bit p: its first data
// bit where the predicate holds, else 0. `cl` takes the code length code's
// table; where `lens` is given, the code lengths go there and the numbers
// of literal/length and distance codes to *nlen and *ndist. Where
// `foreign` is given, it is set to 1 where the predicate fails only on a
// code that zlib takes incomplete (a single 1-bit code, or no distance
// code at all), else 0. In a warp (kWarp) every lane runs it with the same
// result.
template <bool kWarp>
INF_FN unsigned inf_header(const InfStream& s, unsigned p, unsigned char* cl,
                           unsigned char* lens, int* nlen_out,
                           int* ndist_out, int lane, int nl, int* foreign) {
    if (foreign) *foreign = 0;
    InfReader r;
    inf_start(r, s, p);
    const unsigned h = inf_take(r, 17);
    if (((h >> 1) & 3) != 2) return 0;
    const int hlit = (int)(h >> 3) & 31, hdist = (int)(h >> 8) & 31;
    const int ncl = (int)((h >> 13) & 15) + 4;
    if (hlit > 29 || hdist > 29) return 0;
    unsigned long long packed = 0;          // 3 bits a symbol
#pragma unroll
    for (int i = 0; i < 19; ++i) {
        if (i % 10 == 0) inf_fill(r, s);
        if (i < ncl) {
            packed |= (unsigned long long)inf_take(r, 3) << (3 * inf_order(i));
        }
    }
    int kraft = 0;
    unsigned long long cnt = 0;             // 8 bits a length
#pragma unroll
    for (int sym = 0; sym < 19; ++sym) {
        const int l = (int)(packed >> (3 * sym)) & 7;
        if (l) {
            kraft += 128 >> l;
            cnt += 1ull << (8 * l);
        }
    }
    if (kraft != 128) return 0;
    unsigned long long nxt = 0;
    int code = 0;
#pragma unroll
    for (int l = 1; l < 8; ++l) {
        code = (code + (int)((cnt >> (8 * (l - 1))) & 0xFF) * (l > 1)) << 1;
        nxt |= (unsigned long long)code << (8 * l);
    }
#pragma unroll
    for (int sym = 0; sym < 19; ++sym) {
        const int l = (int)(packed >> (3 * sym)) & 7;
        if (l) {
            const unsigned c = (unsigned)(nxt >> (8 * l)) & 0xFFu;
            nxt += 1ull << (8 * l);
            const unsigned char e = (unsigned char)(sym | l << 5);
            for (unsigned f = inf_rev(c, l) + ((unsigned)lane << l); f < 128;
                 f += (unsigned)nl << l) {
                cl[f] = e;
            }
        }
    }
    if (kWarp) INF_SYNC();
    const int nlen = hlit + 257, total = nlen + hdist + 1;
    int have = 0, prev = 0, lit_k = 0, dist_k = 0, eob = 0;
    int lit_n = 0, dist_n = 0;              // codes of non-zero length
    while (have < total) {
        inf_fill(r, s);
        const unsigned e = cl[inf_peek(r, 7)];
        inf_skip(r, (int)(e >> 5));
        const int sym = (int)(e & 31);
        int rep = 1, val = sym;
        if (sym >= 16) {
            if (sym == 16) {
                if (have == 0) return 0;
                rep = 3 + (int)inf_take(r, 2);
                val = prev;
            } else if (sym == 17) {
                rep = 3 + (int)inf_take(r, 3);
                val = 0;
            } else {
                rep = 11 + (int)inf_take(r, 7);
                val = 0;
            }
            if (have + rep > total) return 0;
        }
        if (val) {
            int in_lit = (have + rep < nlen ? have + rep : nlen) - have;
            if (in_lit < 0) in_lit = 0;
            lit_k += in_lit << (15 - val);
            dist_k += (rep - in_lit) << (15 - val);
            lit_n += in_lit;
            dist_n += rep - in_lit;
        }
        if (have <= 256 && 256 < have + rep) eob = val;
        if (lens) {
            for (int j = lane; j < rep; j += nl) {
                lens[have + j] = (unsigned char)val;
            }
        }
        have += rep;
        prev = val;
    }
    if (!eob) return 0;
    if (lit_k != 1 << 15 || dist_k != 1 << 15) {
        if (foreign) {
            const bool lit_ok =
                lit_k == 1 << 15 || (lit_n == 1 && lit_k == 1 << 14);
            const bool dist_ok = dist_k == 1 << 15 || dist_n == 0 ||
                                 (dist_n == 1 && dist_k == 1 << 14);
            *foreign = lit_ok && dist_ok;
        }
        return 0;
    }
    if (lens) {
        *nlen_out = nlen;
        *ndist_out = hdist + 1;
    }
    if (kWarp) INF_SYNC();
    return r.pos;
}

// The warp's tables for the Huffman block whose header is at p (fixed or
// dynamic): its first data bit, or 0 (and *foreign as inf_header sets it).
INF_FN unsigned inf_tables(const InfStream& s, unsigned p, InfWarp& w,
                           int lane, int nl, int* foreign) {
    *foreign = 0;
    InfReader r;
    inf_start(r, s, p);
    const unsigned type = (inf_peek(r, 3) >> 1) & 3;
    int nlen = 288, ndist = 32;
    unsigned data = p + 3;
    if (type == 1) {
        for (int i = lane; i < 320; i += nl) {
            w.lens[i] = (unsigned char)(i < 144 ? 8 : i < 256 ? 9
                                        : i < 280 ? 7 : i < 288 ? 8 : 5);
        }
        INF_SYNC();
    } else {
        data = inf_header<true>(s, p, w.cl, w.lens, &nlen, &ndist, lane, nl,
                                foreign);
        if (!data) return 0;
    }
    inf_build(w.lit, w.lens, nlen, w, lane, nl);
    inf_build(w.dist, w.lens + nlen, ndist, w, lane, nl);
    return data;
}

struct InfResult {
    unsigned end;
    int out_len, last, flags;
};

// Where output byte i of the stream goes in the image's bytes.
INF_FN long long inf_dst(const InfOut& o, long long i) {
    if (o.itemsize == 1) return i;
    return i < o.n_px ? 2 * i : 2 * (i - o.n_px) + 1;
}

// What an emitting thread keeps: where its bytes start, and its Adler-32
// sums.
struct InfSink {
    InfOut o;
    long long base;
    unsigned long long s1, s2;
};

INF_FN void inf_put(InfSink& k, long long i, unsigned b) {
    k.o.px[inf_dst(k.o, i)] = (unsigned char)b;
    k.s1 += b;
    k.s2 += (unsigned long long)i * b;
}

// The block-wide steps. On the card each thread runs the body of
// INF_THREADS for itself and the block meets at INF_BARRIER; code outside
// them is run by every thread alike, on values they all read. A host
// compiler runs each body for every thread in turn, which is the same
// schedule a barrier allows.
#ifdef __CUDACC__
#define INF_THREADS(t) \
    for (int t = (int)threadIdx.x, t##_once = 1; t##_once; t##_once = 0)
#define INF_BARRIER() __syncthreads()
#define INF_THREAD0 if (threadIdx.x == 0)
#define INF_MINE(arr, t) ((arr)[0])
#define INF_MIN(addr, v) atomicMin((addr), (v))
#else
#define INF_THREADS(t) for (int t = 0; t < INF_CTA; ++t)
#define INF_BARRIER() ((void)0)
#define INF_THREAD0
#define INF_MINE(arr, t) ((arr)[t])
#define INF_MIN(addr, v) (*(addr) = (v) < *(addr) ? (v) : *(addr))
#endif

// One thread's chunk: the symbols that start in [start, end), or up to the
// end code or the stream's end. A fault (a distance other than 1, a symbol
// no block may hold) is recorded, the first one, and the decode goes on
// past it as if it were valid, so that a chunk decoded from a wrong start
// still falls into step with the true symbols.
struct InfLane {
    unsigned start, exit;          // first bit, first bit after
    int out, tokens, last, flags;  // bytes, symbols, last literal, INF_L_*
};

#define INF_L_OPENS INF_OPENS      // a match before the chunk's first literal
#define INF_L_FAR INF_FAR          // first fault: a distance other than 1
#define INF_L_BAD INF_BAD          // first fault: an invalid symbol, the end
#define INF_L_EOB 8                // stopped after the end code
#define INF_L_END 16               // stopped at the stream's end
#define INF_L_STOP (INF_L_EOB | INF_L_END)
#define INF_L_HALT (INF_L_FAR | INF_L_BAD | INF_L_STOP)   // ends the walk

// a start map's values past its starts: the chunk ends the walk; the next
// chunk's start lies past its first INF_STARTS bits
#define INF_MAP_STOP INF_STARTS
#define INF_MAP_MISS (INF_STARTS + 1)

// A chunk decoded from one of its first INF_STARTS bits, in 8 bytes: where
// it ends (from the chunk's first bit), its last literal + 1 and flags, its
// bytes and symbols (a chunk holds at most INF_CHUNK symbols).
struct InfStart {
    unsigned short exit;
    unsigned short lf;             // last + 1 | flags << 9
    unsigned ot;                   // out | tokens << 20
};

INF_FN InfStart inf_pack(unsigned exit, int out, int tokens, int last,
                         int flags) {
    return InfStart{(unsigned short)exit,
                    (unsigned short)((unsigned)(last + 1) | flags << 9),
                    (unsigned)out | (unsigned)tokens << 20};
}

INF_FN int inf_s_out(const InfStart& e) { return (int)(e.ot & 0xFFFFFu); }
INF_FN int inf_s_tokens(const InfStart& e) { return (int)(e.ot >> 20); }
INF_FN int inf_s_last(const InfStart& e) { return (int)(e.lf & 511u) - 1; }
INF_FN int inf_s_flags(const InfStart& e) { return (int)(e.lf >> 9); }
INF_FN void inf_s_flag(InfStart& e, int f) {
    e.lf = (unsigned short)(e.lf | f << 9);
}

// A block's threads: the chunks of the window as the walk found them, and
// the block so far.
// A walk's running sums over the chunks: bytes, symbols, the last chunk
// with a literal (or -1).
struct InfScan {
    int out, tokens, lit;
};

struct InfCta {
    InfStart* starts;              // INF_STARTS a thread (dynamic shared)
    unsigned char* map;            // 2 x INF_STARTS x INF_CTA (dynamic)
    InfScan* scan;                 // 2 x INF_CTA (dynamic)
    unsigned char sidx[INF_CTA];   // each chunk's true start from its first
    int first_stop, first_miss, first_over, first_opens, first_lit;
    InfLane lane[INF_CTA];
    int off[INF_CTA];              // emit: the chunk's first output byte
    int prev[INF_CTA];             // emit: the byte before the chunk
    unsigned data, pos;            // the tables' first data bit; window
    long long out, wbase;          // bytes before the window, at its start
    int tokens, last, flags, done, end_lane;
    int nwin, win[INF_WINDOWS];    // the windows of records written
    int foreign;                   // inf_cta_tables: a header for zlib
};

template <bool kEmit>
INF_FN void inf_chunk(const InfStream& s, const InfWarp& w, unsigned start,
                      unsigned end, InfLane& lane, InfSink& k, int prev) {
    InfReader r;
    inf_start(r, s, start);
    int out = 0, last = -1, flags = 0, tokens = 0, fault = 0;
    while (r.pos < end) {
        if (r.pos > s.nbits) {
            fault = fault ? fault : INF_L_BAD;
            flags |= INF_L_END;
            break;
        }
        inf_fill(r, s);
        const int sym = inf_symbol(w.lit, r);
        if (sym == 256) {
            flags |= INF_L_EOB;
            break;
        }
        if (sym < 0) {                  // an incomplete code: no way on
            fault = fault ? fault : INF_L_BAD;
            flags |= INF_L_END;
            break;
        }
        ++tokens;
        if (sym < 256) {
            if (kEmit) inf_put(k, k.base + out, (unsigned)sym);
            last = sym;
            ++out;
            continue;
        }
        if (sym > 285) {
            fault = fault ? fault : INF_L_BAD;
            continue;
        }
        const int lc = sym - 257;
        const int length =
            inf_len_base[lc] + (int)inf_take(r, inf_len_extra[lc]);
        inf_fill(r, s);
        const int dsym = inf_symbol(w.dist, r);
        if (dsym < 0) {
            fault = fault ? fault : INF_L_BAD;
            flags |= INF_L_END;
            break;
        }
        if (dsym > 29) {
            fault = fault ? fault : INF_L_BAD;
            continue;
        }
        if (dsym != 0) {                // distance 1 is code 0, no extra bits
            fault = fault ? fault : INF_L_FAR;
            inf_skip(r, inf_dist_extra[dsym]);
            continue;
        }
        if (last < 0) flags |= INF_L_OPENS;
        if (kEmit) {
            const unsigned b = (unsigned)(last >= 0 ? last : prev);
            for (int j = 0; j < length; ++j) inf_put(k, k.base + out + j, b);
        }
        out += length;
    }
    lane = InfLane{start, r.pos, out, tokens, last, flags | fault};
}

// Every bit set in `mask`, lowest first.
#define INF_EACH_BIT(b, mask) \
    for (unsigned b##_m = (mask), b = 0; b##_m; \
         b##_m &= b##_m - 1)                     \
        if ((b = inf_ctz(b##_m)), true)

INF_FN unsigned inf_ctz(unsigned v) {
#ifdef __CUDACC__
    return (unsigned)(__ffs((int)v) - 1);
#else
    return (unsigned)__builtin_ctz(v);
#endif
}

// The chunk [c0, end) decoded from each of its first INF_STARTS bits, into
// R[0..INF_STARTS): what inf_chunk<false> gives from c0 + j. A start that
// a decode from an earlier start passes through is not decoded again: its
// result is that decode's from there on (the sums less what came before
// it), and a decode that comes to a start whose result is known joins it
// there and stops. With codes of nearly one length (a byte plane of
// noise) the chunk is decoded about once for each bit of a symbol; with
// codes of many lengths the decodes join within a few symbols.
INF_FN void inf_starts(const InfStream& s, const InfWarp& w, unsigned c0,
                       unsigned end, InfStart* R) {
    unsigned covered = 0;
    for (int j = 0; j < INF_STARTS; ++j) {
        if (covered >> j & 1u) continue;
        InfReader r;
        inf_start(r, s, c0 + (unsigned)j);
        int out = 0, tokens = 0, last = -1, last_at = -1, flags = 0,
            fault = 0;
        // the starts this decode passes: all, those whose first literal or
        // match is still to come, those whose first fault is
        unsigned entries = 0, undecided = 0, pending = 0;
#define INF_FAULT(kind)                                              \
    {                                                                \
        fault = fault ? fault : (kind);                              \
        INF_EACH_BIT(b, pending) inf_s_flag(R[b], kind);             \
        pending = 0;                                                 \
    }
        for (;;) {
            const unsigned d = r.pos - c0;
            if (d > (unsigned)j && d < INF_STARTS) {
                if (covered >> d & 1u) {    // join the decode known from d
                    const InfStart m = R[d];
                    const int mflags = inf_s_flags(m);
                    const int mf = mflags & (INF_L_FAR | INF_L_BAD);
                    if (mf) INF_FAULT(mf);
                    if (mflags & INF_L_OPENS) {
                        if (last < 0) flags |= INF_L_OPENS;
                        INF_EACH_BIT(b, undecided) {
                            inf_s_flag(R[b], INF_L_OPENS);
                        }
                    }
                    flags |= mflags & (INF_L_EOB | INF_L_END);
                    out += inf_s_out(m);
                    tokens += inf_s_tokens(m);
                    if (inf_s_last(m) >= 0) {
                        last = inf_s_last(m);
                        last_at = 1 << 30;
                    }
                    r.pos = c0 + m.exit;
                    break;
                }
                covered |= 1u << d;
                entries |= 1u << d;
                undecided |= 1u << d;
                pending |= 1u << d;
                R[d] = inf_pack(0u, out, tokens, -1, 0);
            }
            if (r.pos >= end) break;
            if (r.pos > s.nbits) {
                INF_FAULT(INF_L_BAD);
                flags |= INF_L_END;
                break;
            }
            inf_fill(r, s);
            const int sym = inf_symbol(w.lit, r);
            if (sym == 256) {
                flags |= INF_L_EOB;
                break;
            }
            if (sym < 0) {
                INF_FAULT(INF_L_BAD);
                flags |= INF_L_END;
                break;
            }
            ++tokens;
            if (sym < 256) {
                undecided = 0;
                last = sym;
                last_at = tokens - 1;
                ++out;
                continue;
            }
            if (sym > 285) {
                INF_FAULT(INF_L_BAD);
                continue;
            }
            const int lc = sym - 257;
            const int length =
                inf_len_base[lc] + (int)inf_take(r, inf_len_extra[lc]);
            inf_fill(r, s);
            const int dsym = inf_symbol(w.dist, r);
            if (dsym < 0) {
                INF_FAULT(INF_L_BAD);
                flags |= INF_L_END;
                break;
            }
            if (dsym > 29) {
                INF_FAULT(INF_L_BAD);
                continue;
            }
            if (dsym != 0) {
                INF_FAULT(INF_L_FAR);
                inf_skip(r, inf_dist_extra[dsym]);
                continue;
            }
            if (last < 0) flags |= INF_L_OPENS;
            INF_EACH_BIT(b, undecided) inf_s_flag(R[b], INF_L_OPENS);
            undecided = 0;
            out += length;
        }
#undef INF_FAULT
        const int stop = flags & (INF_L_EOB | INF_L_END);
        INF_EACH_BIT(b, entries) {
            const InfStart e = R[b];
            const int before = inf_s_tokens(e);
            R[b] = inf_pack(r.pos - c0, out - inf_s_out(e), tokens - before,
                            last_at >= before ? last : -1,
                            inf_s_flags(e) | stop);
        }
        R[j] = inf_pack(r.pos - c0, out, tokens, last, flags | fault);
    }
}

// The walk over a window's chunks one after the other (thread 0): each
// chunk's true start is where the one before it ends; a start past the
// chunk's first INF_STARTS bits is decoded here. Fills the lanes, their
// output offsets and predecessor bytes, and the block so far.
INF_FN void inf_walk_serial(const InfStream& s, const InfWarp& w, InfCta& c,
                            unsigned pos0, long long limit, int max_tokens,
                            int prev) {
    long long wout = 0;
    int last = c.last, end_lane = INF_CTA - 1;
    unsigned at = pos0;             // the true start of chunk t
    for (int t = 0; t < INF_CTA; ++t) {
        const unsigned c0 = pos0 + t * INF_CHUNK;
        InfLane& lane = c.lane[t];
        if (at - c0 < INF_STARTS) {
            const InfStart e = c.starts[t * INF_STARTS + (at - c0)];
            lane = InfLane{at, c0 + e.exit, inf_s_out(e),
                           inf_s_tokens(e), inf_s_last(e),
                           inf_s_flags(e)};
        } else {                    // a symbol longer than the starts
            InfSink none{};
            inf_chunk<false>(s, w, at, c0 + INF_CHUNK, lane, none, 0);
        }
        if (c.out + wout > limit || c.tokens > max_tokens) {
            c.flags |= INF_BAD;
            c.done = 1;
            end_lane = t - 1;
            break;
        }
        c.off[t] = (int)wout;
        c.prev[t] = last >= 0 ? last : prev;
        if ((lane.flags & INF_L_OPENS) && last < 0) c.flags |= INF_OPENS;
        wout += lane.out;
        c.tokens += lane.tokens;
        if (lane.last >= 0) last = lane.last;
        at = lane.exit;
        if (lane.flags & (INF_L_FAR | INF_L_BAD | INF_L_STOP)) {
            c.flags |= lane.flags & (INF_FAR | INF_BAD);
            c.done = 1;
            end_lane = t;
            break;
        }
    }
    c.end_lane = end_lane;
    c.wbase = c.out;
    c.out += wout;
    c.last = last;
    c.pos = at;
    if (c.out > limit || c.tokens > max_tokens) {
        c.flags |= INF_BAD;
        c.done = 1;
    }
}

// The same walk by every thread at once. Thread t's starts map each of its
// first INF_STARTS bits to the next chunk's start (or to INF_MAP_STOP where
// the chunk ends the walk, INF_MAP_MISS where the next start lies past
// them); a scan composes the maps, so that thread t reads its true start
// off the composition of the maps before it, and a second scan sums the
// chunks' bytes and symbols and finds the last literal before each. Returns
// 0 (every thread alike) where a start lies past the first bits, for the
// serial walk to do instead.
INF_FN int inf_walk(InfCta& c, unsigned pos0, long long limit, int max_tokens,
                    int prev) {
    const int J = INF_STARTS, T = INF_CTA;
    unsigned char* a = c.map;
    unsigned char* b = c.map + J * T;
    INF_THREAD0 {
        c.first_stop = c.first_miss = c.first_over = T;
        c.first_opens = c.first_lit = T;
    }
    INF_THREADS(t) {
        const InfStart* R = c.starts + t * J;
        for (int j = 0; j < J; ++j) {
            const InfStart e = R[j];
            const unsigned next = e.exit - (unsigned)INF_CHUNK;
            a[j * T + t] = (unsigned char)(
                (inf_s_flags(e) & INF_L_HALT) ? INF_MAP_STOP
                : next < (unsigned)J          ? (int)next
                                              : INF_MAP_MISS);
        }
    }
    INF_BARRIER();
    for (int k = 1; k < T; k <<= 1) {       // a[.][t]: maps t-2k+1 .. t
        INF_THREADS(t) {
            for (int j = 0; j < J; ++j) {
                int v = a[j * T + t];
                if (t >= k) {
                    const int x = a[j * T + t - k];
                    v = x < J ? a[x * T + t] : x;
                }
                b[j * T + t] = (unsigned char)v;
            }
        }
        INF_BARRIER();
        unsigned char* swap = a;
        a = b;
        b = swap;
    }
    InfScan* sa = c.scan;
    InfScan* sb = c.scan + T;
    INF_THREADS(t) {
        const int st = t == 0 ? 0 : a[t - 1];   // maps 0 .. t-1, from 0
        c.sidx[t] = (unsigned char)st;
        InfScan v{0, 0, -1};
        if (st < J) {
            const unsigned c0 = pos0 + t * INF_CHUNK;
            const InfStart e = c.starts[t * J + st];
            const InfLane lane{c0 + st, c0 + e.exit, inf_s_out(e),
                               inf_s_tokens(e), inf_s_last(e),
                               inf_s_flags(e)};
            c.lane[t] = lane;
            v = InfScan{lane.out, lane.tokens, lane.last >= 0 ? t : -1};
            if (lane.flags & INF_L_HALT) INF_MIN(&c.first_stop, t);
            if (lane.flags & INF_L_OPENS) INF_MIN(&c.first_opens, t);
            if (lane.last >= 0) INF_MIN(&c.first_lit, t);
        } else if (st == INF_MAP_MISS) {
            INF_MIN(&c.first_miss, t);
        }
        sa[t] = v;
    }
    INF_BARRIER();
    if (c.first_miss < T) return 0;
    for (int k = 1; k < T; k <<= 1) {
        INF_THREADS(t) {
            InfScan v = sa[t];
            if (t >= k) {
                const InfScan u = sa[t - k];
                v.out += u.out;
                v.tokens += u.tokens;
                if (v.lit < 0) v.lit = u.lit;
            }
            sb[t] = v;
        }
        INF_BARRIER();
        InfScan* swap = sa;
        sa = sb;
        sb = swap;
    }
    INF_THREADS(t) {
        const InfScan ex = t ? sa[t - 1] : InfScan{0, 0, -1};
        c.off[t] = ex.out;
        c.prev[t] = ex.lit >= 0 ? c.lane[ex.lit].last
                    : c.last >= 0 ? c.last : prev;
        if (t <= c.first_stop && (c.out + ex.out > limit ||
                                  c.tokens + ex.tokens > max_tokens)) {
            INF_MIN(&c.first_over, t);
        }
    }
    INF_BARRIER();
    INF_THREAD0 {
        int end_lane = c.first_stop < T ? c.first_stop : T - 1;
        if (c.first_over <= end_lane) {
            c.flags |= INF_BAD;
            c.done = 1;
            end_lane = c.first_over - 1;
        } else if (c.first_stop < T) {
            c.flags |= c.lane[end_lane].flags & (INF_FAR | INF_BAD);
            c.done = 1;
        }
        if (c.last < 0 && c.first_opens <= end_lane &&
            c.first_opens <= c.first_lit) {
            c.flags |= INF_OPENS;
        }
        const InfScan in = end_lane >= 0 ? sa[end_lane] : InfScan{0, 0, -1};
        c.end_lane = end_lane;
        c.wbase = c.out;
        c.out += in.out;
        c.tokens += in.tokens;
        if (in.lit >= 0) c.last = c.lane[in.lit].last;
        if (end_lane >= 0) c.pos = c.lane[end_lane].exit;
        if (c.out > limit || c.tokens > max_tokens) {
            c.flags |= INF_BAD;
            c.done = 1;
        }
    }
    return 1;
}

INF_FN int inf_take_window(InfHead* head) {
#ifdef __CUDACC__
    return atomicAdd(&head->nwin, 1);
#else
    return head->nwin++;
#endif
}

// Decodes the Huffman block whose data starts at bit `data` with the tables
// in `w`, to its end code: the same result as one thread decoding it symbol
// by symbol (it fails, INF_BAD, past `limit` bytes or `max_tokens`
// symbols). Window by window, thread t takes the INF_CHUNK bits from
// `pos + t * INF_CHUNK` and decodes from there as if a symbol started
// there; thread 0's start is true. Then, round by round, a thread whose
// start is not where its predecessor's last symbol ends decodes again from
// there, until no chunk's end moves: a Huffman code falls back into step
// within a few symbols, so a round or two usually settles the window
// (Weissenberger and Schmidt, ICPP 2018). Thread 0 then adds the chunks
// up; with kEmit every thread decodes its chunk a last time and stores its
// bytes through its sink (`k`, `base` the block's first output byte, `prev`
// the byte before it). With `rec`, each window's chunks are kept in its
// record pool (c.win, c.nwin; -1 where they did not fit), from which the
// emit decodes each chunk once.
template <bool kEmit>
INF_FN InfResult inf_block(const InfStream& s, const InfWarp& w, InfCta& c,
                           unsigned data, long long limit, int max_tokens,
                           InfSink* k, int prev, long long base,
                           const InfWs* rec) {
    INF_THREAD0 {
        c.pos = data;
        c.out = 0;
        c.tokens = 0;
        c.last = -1;
        c.flags = 0;
        c.done = 0;
        c.nwin = 0;
    }
    INF_BARRIER();
    while (!c.done) {
        const unsigned pos0 = c.pos;
        INF_THREADS(t) {
            inf_starts(s, w, pos0 + t * INF_CHUNK, pos0 + (t + 1) * INF_CHUNK,
                       c.starts + t * INF_STARTS);
        }
        INF_BARRIER();
        if (!inf_walk(c, pos0, limit, max_tokens, prev)) {
            INF_THREAD0 inf_walk_serial(s, w, c, pos0, limit, max_tokens,
                                        prev);
        }
        INF_THREAD0 {
            if (rec && c.nwin >= 0) {       // a window of records
                const int wi = c.nwin < INF_WINDOWS
                                   ? inf_take_window(rec->head) : -1;
                if (wi >= 0 && wi < rec->win_cap) {
                    c.win[c.nwin++] = wi;
                    rec->wins[wi] = InfWin{pos0, c.end_lane + 1, c.wbase};
                } else {
                    c.nwin = -1;
                }
            }
        }
        INF_BARRIER();
        if (rec && c.nwin > 0) {
            InfRec* out = rec->recs + (long long)c.win[c.nwin - 1] * INF_CTA;
            INF_THREADS(t) {
                if (t <= c.end_lane) {
                    out[t] = InfRec{c.lane[t].start, c.off[t], c.prev[t]};
                }
            }
            INF_BARRIER();
        }
        if (kEmit) {
            INF_THREADS(t) {
                if (t <= c.end_lane) {
                    InfSink& mine = INF_MINE(k, t);
                    mine.base = base + c.wbase + c.off[t];
                    InfLane again;
                    inf_chunk<true>(s, w, c.lane[t].start,
                                    pos0 + (t + 1) * INF_CHUNK, again, mine,
                                    c.prev[t]);
                }
            }
            INF_BARRIER();
        }
    }
    return InfResult{c.pos, (int)c.out, c.last, c.flags};
}

// The tables of the Huffman block whose header is at p, built by the first
// warp (one lane on a host): the first data bit, or 0, for every thread
// (and c.foreign as inf_header sets it).
INF_FN unsigned inf_cta_tables(const InfStream& s, unsigned p, InfWarp& w,
                               InfCta& c) {
#ifdef __CUDACC__
    if (threadIdx.x < 32) {
        int foreign;
        const unsigned d = inf_tables(s, p, w, (int)threadIdx.x, 32,
                                      &foreign);
        if (threadIdx.x == 0) {
            c.data = d;
            c.foreign = foreign;
        }
    }
#else
    c.data = inf_tables(s, p, w, 0, 1, &c.foreign);
#endif
    INF_BARRIER();
    return c.data;
}

// The candidate at bit p, or -1 (the hash the scan fills).
INF_FN int inf_lookup(const InfWs& ws, unsigned p) {
    unsigned slot = (p * 2654435761u) & (unsigned)ws.hmask;
    for (;;) {
        const unsigned key = ws.hkey[slot];
        if (key == 0) return -1;
        if (key == p + 1) return ws.hval[slot];
        slot = (slot + 1) & (unsigned)ws.hmask;
    }
}

// Emits a chain block into the image through the threads' sinks `k`,
// which keep their Adler-32 sums.
INF_FN void inf_emit(const InfStream& s, const InfWs& ws, const InfBlock& blk,
                     InfWarp& w, InfCta& c, InfSink* k) {
    if (blk.type == 0) {
        INF_THREADS(t) {
            InfSink& mine = INF_MINE(k, t);
            for (int j = t; j < blk.out_len; j += INF_CTA) {
                inf_put(mine, (long long)blk.out_off + j,
                        inf_byte(s, (long long)blk.src + j));
            }
        }
        return;
    }
    const unsigned data = inf_cta_tables(s, blk.start, w, c);
    if (blk.cand < 0) {                 // find the chunks' starts again
        inf_block<true>(s, w, c, data, blk.out_len, 1 << 30, k, blk.prev,
                        blk.out_off, nullptr);
        return;
    }
    const InfCand& cd = ws.cand[blk.cand];
    for (int i = 0; i < cd.nwin; ++i) {
        const InfWin win = ws.wins[cd.win[i]];
        const InfRec* recs = ws.recs + (long long)cd.win[i] * INF_CTA;
        INF_THREADS(t) {
            if (t < win.nlanes) {
                const InfRec r = recs[t];
                InfSink& mine = INF_MINE(k, t);
                mine.base = blk.out_off + win.wbase + r.off;
                InfLane again;
                inf_chunk<true>(s, w, r.start,
                                win.pos0 + (t + 1) * INF_CHUNK, again, mine,
                                r.prev >= 0 ? r.prev : blk.prev);
            }
        }
    }
}

// The walk over the blocks from bit 16 (every thread alike; thread 0
// writes). Leaves the status, the blocks, their count and the trailer;
// blocks past the chain's cap it emits itself, through the sinks `k`.
INF_FN void inf_chain(const InfStream& s, const InfWs& ws, long long want,
                      InfWarp& w, InfCta& c, InfSink* k) {
    InfHead* head = ws.head;
    int status = INF_OK, nb = 0, nserial = 0, last = -1;
    long long total = 0;
    unsigned p = 16;
    while (status == INF_OK) {
        InfReader r;
        inf_start(r, s, p);
        const unsigned hdr = inf_peek(r, 3);
        const int final = (int)(hdr & 1), type = (int)(hdr >> 1);
        InfBlock blk;
        blk.start = p;
        blk.type = type;
        blk.out_off = (int)total;
        blk.prev = last;
        blk.src = 0;
        blk.cand = -1;
        if (type == 0) {
            const unsigned q = (p + 3 + 7) & ~7u;
            const unsigned b0 = q / 8 + 4;
            inf_start(r, s, q);
            const unsigned ln = inf_take(r, 16), nln = inf_take(r, 16);
            if ((unsigned long long)q + 32 > s.nbits ||
                ln != (~nln & 0xFFFFu) ||
                (unsigned long long)b0 + ln > s.nbytes) {
                status = INF_BROKEN;
                break;
            }
            blk.out_len = (int)ln;
            blk.src = (int)b0;
            if (ln) last = (int)inf_byte(s, b0 + ln - 1);
            p = 8 * (b0 + ln);
        } else if (type == 3) {
            status = INF_BROKEN;
            break;
        } else {
            InfResult res;
            const int cand = type == 2 ? inf_lookup(ws, p) : -1;
            if (cand >= 0 && !(ws.cand[cand].flags & INF_BAD)) {
                const InfCand& cd = ws.cand[cand];
                res = InfResult{cd.end, cd.out_len, cd.last, cd.flags};
                if (cd.nwin > 0) blk.cand = cand;
            } else {
                ++nserial;
                const unsigned data = inf_cta_tables(s, p, w, c);
                if (!data) {
                    status = c.foreign ? INF_FOREIGN : INF_BROKEN;
                    break;
                }
                res = inf_block<false>(s, w, c, data, want, 1 << 30, nullptr,
                                       -1, 0, nullptr);
            }
            if (res.flags & INF_FAR) {
                status = INF_FOREIGN;
                break;
            }
            if ((res.flags & INF_BAD) || res.end > s.nbits ||
                ((res.flags & INF_OPENS) && last < 0)) {
                status = INF_BROKEN;
                break;
            }
            blk.out_len = res.out_len;
            if (res.last >= 0) last = res.last;
            p = res.end;
        }
        ++nb;
        total += blk.out_len;
        if (total > want) {
            status = INF_LENGTH;
            break;
        }
        if (nb <= ws.chain_cap) {
            INF_THREAD0 ws.blocks[nb - 1] = blk;
        } else {
            inf_emit(s, ws, blk, w, c, k);
        }
        if (final) break;
    }
    if (status == INF_OK && total != want) status = INF_LENGTH;
    const unsigned tail = (p + 7) / 8;
    if (status == INF_OK && (unsigned long long)tail + 4 > s.nbytes) {
        status = INF_BROKEN;
    }
    INF_THREAD0 {
        head->status = status;
        head->nblocks = nb;
        head->nserial = nserial;
        head->total = total;
        if (status == INF_OK) {
            head->trailer = inf_byte(s, tail) << 24 |
                            inf_byte(s, tail + 1) << 16 |
                            inf_byte(s, tail + 2) << 8 | inf_byte(s, tail + 3);
        }
    }
}

// Adler-32 of `total` bytes from the sums S1 = sum b and S2 = sum i * b.
INF_FN unsigned inf_adler(unsigned long long s1, unsigned long long s2,
                          long long total) {
    const unsigned long long nm = (unsigned long long)total % INF_ADLER_BASE;
    const unsigned a = (unsigned)((1 + s1) % INF_ADLER_BASE);
    const unsigned b = (unsigned)((nm + nm * (s1 % INF_ADLER_BASE) +
                                   INF_ADLER_BASE - s2 % INF_ADLER_BASE) %
                                  INF_ADLER_BASE);
    return b << 16 | a;
}

// ---------------------------------------------------------------------------
// the workspace (host code)
// ---------------------------------------------------------------------------

static long long inf_cap(long long nbytes) {
    return INF_CAP_MIN + nbytes / INF_CAP_PER;
}

static long long inf_chain_cap(long long want) {
    return INF_CHAIN_MIN + want / INF_CHAIN_PER;
}

static long long inf_win_cap(long long nbytes) {
    return 64 + 2 * (8 * nbytes) / ((long long)INF_CTA * INF_CHUNK);
}

static long long inf_hash_slots(long long nbytes) {
    long long h = 1;
    while (h < 2 * inf_cap(nbytes)) h <<= 1;
    return h;
}

static long long inf_align(long long v) { return (v + 255) & ~255LL; }

// Carves the workspace into its arrays; returns its size in bytes.
static long long inf_layout(long long nbytes, long long want, char* base,
                            InfWs* ws) {
    long long off = 0;
    auto take = [&](long long bytes) {
        char* p = base ? base + off : nullptr;
        off += inf_align(bytes);
        return p;
    };
    InfWs w;
    w.cap = (int)inf_cap(nbytes);
    w.chain_cap = (int)inf_chain_cap(want);
    const long long slots = inf_hash_slots(nbytes);
    w.hmask = (int)(slots - 1);
    w.head = (InfHead*)take(sizeof(InfHead));
    w.hkey = (unsigned*)take(4 * slots);
    w.hval = (int*)take(4 * slots);
    w.cand = (InfCand*)take(sizeof(InfCand) * w.cap);
    w.blocks = (InfBlock*)take(sizeof(InfBlock) * w.chain_cap);
    w.win_cap = (int)inf_win_cap(nbytes);
    w.wins = (InfWin*)take(sizeof(InfWin) * w.win_cap);
    w.recs = (InfRec*)take(sizeof(InfRec) * INF_CTA * w.win_cap);
    if (ws) *ws = w;
    return off;
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------
#ifdef __CUDACC__

// The rest of the predicate at p, and the candidate's place in the list
// and the hash where it holds.
__device__ void inf_scan_push(const InfStream& s, const InfWs& ws,
                              unsigned p, unsigned char* cl) {
    if (!inf_header<false>(s, p, cl, nullptr, nullptr, nullptr, 0, 1,
                           nullptr)) {
        return;
    }
    const int c = atomicAdd(&ws.head->ncand, 1);
    if (c >= ws.cap) return;
    ws.cand[c].start = p;
    unsigned slot = (p * 2654435761u) & (unsigned)ws.hmask;
    while (atomicCAS(ws.hkey + slot, 0u, p + 1) != 0u) {
        slot = (slot + 1) & (unsigned)ws.hmask;
    }
    ws.hval[slot] = c;
}

__global__ void __launch_bounds__(INF_SCAN_THREADS)
inflate_scan_kernel(InfStream s, InfWs ws) {
    __shared__ unsigned char cl[INF_SCAN_THREADS][128];
    __shared__ unsigned queue[INF_SCAN_QUEUE];
    __shared__ int nq;
    if (threadIdx.x == 0) nq = 0;
    __syncthreads();
    // 32 offsets a thread, from b = 16 mod 32, tested on a 128-bit window
    // of registers: the 17-bit header (BTYPE, HLIT, HDIST; ~22% pass),
    // then the code length code's completeness (~0.1% of offsets pass).
    // Those go to a queue, which all the block's threads then take through
    // the rest of the predicate.
    const long long b =
        16 + 32 * ((long long)blockIdx.x * INF_SCAN_THREADS + threadIdx.x);
    if (b < s.nbits) {
        const long long wi = b >> 5;
        const unsigned long long w2 = inf_word(s, wi + 2);
        const unsigned long long lo = (unsigned long long)inf_word(s, wi) >> 16 |
                                      (unsigned long long)inf_word(s, wi + 1)
                                          << 16 |
                                      w2 << 48;
        const unsigned long long hi = w2 >> 16 |
                                      (unsigned long long)inf_word(s, wi + 3)
                                          << 16 |
                                      (unsigned long long)inf_word(s, wi + 4)
                                          << 48;
        for (int k = 0; k < 32 && b + k < s.nbits; ++k) {
            const unsigned h = (unsigned)(lo >> k) & 0x1FFFFu;
            if (((h >> 1) & 3) != 2 || ((h >> 3) & 31) > 29 ||
                ((h >> 8) & 31) > 29) {
                continue;
            }
            const int q = k + 17;
            const unsigned long long f = lo >> q | hi << (64 - q);
            const int ncl = (int)((h >> 13) & 15) + 4;
            int kraft = 0;
#pragma unroll
            for (int i = 0; i < 19; ++i) {
                const int l = (int)(f >> (3 * i)) & 7;
                if (i < ncl && l) kraft += 128 >> l;
            }
            if (kraft != 128) continue;
            const int at = atomicAdd(&nq, 1);
            if (at < INF_SCAN_QUEUE) {
                queue[at] = (unsigned)(b + k);
            } else {
                inf_scan_push(s, ws, (unsigned)(b + k), cl[threadIdx.x]);
            }
        }
    }
    __syncthreads();
    const int n = nq < INF_SCAN_QUEUE ? nq : INF_SCAN_QUEUE;
    for (int i = (int)threadIdx.x; i < n; i += INF_SCAN_THREADS) {
        inf_scan_push(s, ws, queue[i], cl[threadIdx.x]);
    }
}

extern __shared__ InfStart inf_dyn_starts[];   // INF_CTA * INF_STARTS

#define INF_DYN_BYTES                                                   \
    ((int)((sizeof(InfStart) + 2) * INF_CTA * INF_STARTS +             \
           2 * sizeof(InfScan) * INF_CTA))

// Points the block's arrays into its dynamic shared memory.
__device__ void inf_carve(InfCta& c) {
    if (threadIdx.x == 0) {
        char* p = (char*)inf_dyn_starts;
        c.starts = (InfStart*)p;
        p += sizeof(InfStart) * INF_CTA * INF_STARTS;
        c.scan = (InfScan*)p;
        p += 2 * sizeof(InfScan) * INF_CTA;
        c.map = (unsigned char*)p;
    }
}

__global__ void __launch_bounds__(INF_CTA)
inflate_measure_kernel(InfStream s, InfWs ws, long long want) {
    __shared__ InfWarp w;
    __shared__ InfCta c;
    const int n = ws.head->ncand;
    if ((int)blockIdx.x >= (n < ws.cap ? n : ws.cap)) return;
    inf_carve(c);
    const unsigned p = ws.cand[blockIdx.x].start;
    const unsigned data = inf_cta_tables(s, p, w, c);
    InfResult res{p, 0, -1, INF_BAD};
    if (data) {
        res = inf_block<false>(s, w, c, data, want, INF_MAX_TOKENS, nullptr,
                               -1, 0, &ws);
    }
    if (threadIdx.x == 0) {
        InfCand& cd = ws.cand[blockIdx.x];
        cd.end = res.end;
        cd.out_len = res.out_len;
        cd.last = res.last;
        cd.flags = res.flags;
        cd.nwin = data ? c.nwin : -1;
        for (int i = 0; i < INF_WINDOWS; ++i) cd.win[i] = c.win[i];
    }
}

// Adds the threads' Adler-32 sums to the head's.
__device__ void inf_add_sums(InfHead* head, InfSink& k) {
    for (int off = 16; off > 0; off >>= 1) {
        k.s1 += __shfl_down_sync(0xFFFFFFFFu, k.s1, off);
        k.s2 += __shfl_down_sync(0xFFFFFFFFu, k.s2, off);
    }
    if ((threadIdx.x & 31) == 0) {
        if (k.s1) atomicAdd(&head->s1, k.s1);
        if (k.s2) atomicAdd(&head->s2, k.s2);
        __threadfence();
    }
}

__global__ void __launch_bounds__(INF_CTA)
inflate_chain_kernel(InfStream s, InfWs ws, long long want, InfOut o) {
    __shared__ InfWarp w;
    __shared__ InfCta c;
    InfSink k{};
    k.o = o;
    inf_carve(c);
    __syncthreads();
    inf_chain(s, ws, want, w, c, &k);
    inf_add_sums(ws.head, k);
}

__global__ void __launch_bounds__(INF_CTA)
inflate_emit_kernel(InfStream s, InfWs ws, InfOut o) {
    __shared__ InfWarp w;
    __shared__ InfCta c;
    InfHead* head = ws.head;
    InfSink k{};
    k.o = o;
    inf_carve(c);
    __syncthreads();
    if (head->status == INF_OK && (int)blockIdx.x < head->nblocks) {
        inf_emit(s, ws, ws.blocks[blockIdx.x], w, c, &k);
    }
    inf_add_sums(head, k);
    __syncthreads();
    if (threadIdx.x == 0 && atomicAdd(&head->done, 1u) == gridDim.x - 1) {
        __threadfence();
        const unsigned long long s1 = atomicAdd(&head->s1, 0ull);
        const unsigned long long s2 = atomicAdd(&head->s2, 0ull);
        if (head->status == INF_OK &&
            inf_adler(s1, s2, head->total) != head->trailer) {
            head->status = INF_ADLER;
        }
    }
}

extern "C" {

// Bytes of the workspace for a stream of `nbytes` bytes that inflates to
// `want`; its first bytes are the InfHead the host reads back.
long long inflate_buffer_bytes(long long nbytes, long long want) {
    return inf_layout(nbytes, want, nullptr, nullptr);
}

// words: the stream, padded with zeros to whole words; nbytes its length;
// px, n_px, itemsize: the image it inflates into (want = n_px * itemsize).
int inflate_sdfl(const void* words, long long nbytes, void* px,
                 long long n_px, int itemsize, void* buf,
                 long long buf_bytes, void* stream) {
    const long long want = n_px * itemsize;
    if (!words || !px || !buf || nbytes < 2 || nbytes > INF_MAX_STREAM ||
        want < 1 || want > INF_MAX_STREAM || (itemsize != 1 && itemsize != 2)) {
        return (int)cudaErrorInvalidValue;
    }
    InfWs ws;
    const long long ws_bytes = inf_layout(nbytes, want, (char*)buf, &ws);
    if (buf_bytes < ws_bytes) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(buf, 0, (size_t)ws_bytes, st);
    if (err != cudaSuccess) return (int)err;
    const InfStream s{(const unsigned*)words, (nbytes + 3) / 4,
                      (unsigned)(8 * nbytes), (unsigned)nbytes};
    const InfOut o{(unsigned char*)px, n_px, itemsize};
    const long long per_block = 32LL * INF_SCAN_THREADS;
    const int scan_blocks = (int)((8 * nbytes - 16 + per_block) / per_block);
    const void* big[3] = {(const void*)inflate_measure_kernel,
                          (const void*)inflate_chain_kernel,
                          (const void*)inflate_emit_kernel};
    for (const void* fn : big) {
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, INF_DYN_BYTES);
        if (err != cudaSuccess) return (int)err;
    }
    inflate_scan_kernel<<<scan_blocks, INF_SCAN_THREADS, 0, st>>>(s, ws);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    inflate_measure_kernel<<<ws.cap, INF_CTA, INF_DYN_BYTES, st>>>(s, ws,
                                                                    want);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    inflate_chain_kernel<<<1, INF_CTA, INF_DYN_BYTES, st>>>(s, ws, want, o);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    inflate_emit_kernel<<<ws.chain_cap, INF_CTA, INF_DYN_BYTES, st>>>(s, ws,
                                                                       o);
    return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // __CUDACC__
