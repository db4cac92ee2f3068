"""The deflate codec's encode of a stego image, zlib's bytes bit for bit,
as hand-written CUDA kernels (``csrc/deflate_rle.cu``) and their plain
NumPy version.

The ``deflate`` transport codec (:class:`..io.codecs.DeflateCodec`) writes
a 13-byte ``SDFL`` header and then ``zlib.compressobj(1, DEFLATED, 15, 9,
Z_RLE)`` of the image's bytes: uint16 as its low-byte plane followed by its
high-byte plane (SDFL code 3), uint8 as it is (code 1). At level 1 with
``Z_RLE``, zlib's ``deflate_rle`` is a deterministic function of its input,
and a simple one:

* **Tokens.** A byte is a literal unless the three bytes from it repeat
  the byte before it; then it starts a match at distance 1 as long as the
  run goes, at most 258 bytes (``MAX_MATCH``). So the tokens are a function
  of the maximal runs of equal bytes alone: a run of R bytes gives one
  literal, then matches of 258 while 258 or more of it are left, then a
  match of the rest if 3 or more are left, else 1 or 2 literals. The
  stream's first byte is a literal.
* **Blocks.** A block ends after every 32,767 tokens (``lit_bufsize - 1``
  at ``memLevel`` 9) and at the end of the input, so the last block may
  hold no token at all.
* **The choice.** Each block is stored, static or dynamic Huffman, by the
  sizes that ``trees.c`` computes from the block's symbol counts
  (:func:`block_code`, an exact port of ``build_tree``, ``gen_bitlen``,
  ``gen_codes``, ``scan_tree`` and ``build_bl_tree`` with the heap's
  ``depth`` tie-break). A block may be stored only while its first byte
  is still in zlib's 64 KiB window (``buf != NULL`` in
  ``_tr_flush_block``); the window slides at positions that follow from
  the token boundaries and the input's length alone (:func:`slides_by`,
  from ``fill_window``).

Only the Huffman trees are serial, one small job per block, and blocks do
not depend on each other. The kernels (:func:`encode_device`) are three
launches and a memset on the current stream: ``deflate_rle_tokens`` reads
the image as the split stream without materialising it, finds each
token's global index with a decoupled look-back and counts each block's
symbols; ``deflate_rle_trees`` builds each block's trees (one block of
threads per deflate block, one thread doing the serial part) and lays the
blocks out; ``deflate_rle_emit`` writes every token's code at its bit
offset, each block's header, trees and end code, the stored blocks' bytes
and the Adler-32 trailer. The host reads the length back, then exactly
that many bytes.

:func:`transport_encode` is what the single-image encodes call in their
``transport_codec`` stage: the ``deflate`` codec's encode of a stego that
is a CUDA tensor always runs on the card, and :func:`check_device_route`
raises where this process's zlib gives other bytes than the kernels on a
probe (zlib-ng, a patched zlib); everything else stays on the host codec.
Counters: ``codec.deflate_device`` and ``codec.deflate_host`` (streams
encoded on each side by that function) and ``launch.<kernel>`` per launch.
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import profiling
from ..device import download, upload
from .kernel_library import check, library, stream_ptr

__all__ = [
    "KERNELS",
    "BlockCode",
    "block_code",
    "check_device_route",
    "deflate_rle_plain",
    "encode_device",
    "encode_plain",
    "probe_images",
    "queue_device",
    "rle_tokens",
    "slides_by",
    "split_stream",
    "transport_encode",
]

KERNELS = ("deflate_rle_tokens", "deflate_rle_trees", "deflate_rle_emit")

# deflate.h / deflate.c at level 1, windowBits 15, memLevel 9
WSIZE = 1 << 15
MAX_MATCH = 258
MIN_MATCH = 3
MIN_LOOKAHEAD = MAX_MATCH + MIN_MATCH + 1
BLOCK_TOKENS = (1 << (9 + 6)) - 1       # lit_bufsize - 1
ZLIB_HEADER = b"\x78\x01"               # level 1 sets no FLEVEL bits
ADLER_BASE = 65521
# the codec's own header (io/codecs: b"SDFL" + ">BII" code, h, w)
SDFL_MAGIC = b"SDFL"
SDFL_CODES = {np.dtype(np.uint8): 1, np.dtype(np.uint16): 3}

# trees.c
L_CODES, D_CODES, BL_CODES = 286, 30, 19
END_BLOCK = 256
MAX_BITS, MAX_BL_BITS = 15, 7
HEAP_SIZE = 2 * L_CODES + 1
REP_3_6, REPZ_3_10, REPZ_11_138 = 16, 17, 18
EXTRA_LBITS = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
               4, 4, 4, 4, 5, 5, 5, 5, 0)
EXTRA_DBITS = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8,
               9, 9, 10, 10, 11, 11, 12, 12, 13, 13)
EXTRA_BLBITS = (0,) * 16 + (2, 3, 7)
BL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
STORED, STATIC, DYNAMIC = 0, 1, 2


def _length_tables() -> Tuple[np.ndarray, np.ndarray]:
    """``_length_code`` (match length - 3 -> length code 0..28) and
    ``base_length`` of trees.c, with length 258 on code 28 (285)."""
    base = np.zeros(29, np.int64)
    code_of = np.zeros(256, np.int64)
    length = 0
    for code in range(28):
        base[code] = length
        for _ in range(1 << EXTRA_LBITS[code]):
            code_of[length] = code
            length += 1
    code_of[255] = 28
    return code_of, base


LENGTH_CODE, BASE_LENGTH = _length_tables()


def _static_lit_lengths() -> np.ndarray:
    lens = np.empty(L_CODES + 2, np.int64)
    lens[:144], lens[144:256], lens[256:280], lens[280:] = 8, 9, 7, 8
    return lens


STATIC_LIT_LEN = _static_lit_lengths()


def _reverse(code: int, length: int) -> int:
    out = 0
    for _ in range(length):
        out = (out << 1) | (code & 1)
        code >>= 1
    return out


def _canonical_codes(lens, max_code: int) -> List[int]:
    """``gen_codes``: bit-reversed canonical codes of lengths ``lens``."""
    bl_count = [0] * (MAX_BITS + 1)
    for n in range(max_code + 1):
        bl_count[lens[n]] += 1
    next_code = [0] * (MAX_BITS + 1)
    code = 0
    for bits in range(1, MAX_BITS + 1):
        code = (code + (bl_count[bits - 1] if bits > 1 else 0)) << 1
        next_code[bits] = code
    codes = [0] * len(lens)
    for n in range(max_code + 1):
        ln = lens[n]
        if ln:
            codes[n] = _reverse(next_code[ln], ln)
            next_code[ln] += 1
    return codes


STATIC_LIT_CODE = _canonical_codes(list(STATIC_LIT_LEN), L_CODES + 1)
STATIC_DIST_CODE = [_reverse(n, 5) for n in range(D_CODES)]


# ---------------------------------------------------------------------------
# plain version: the kernels' spec, stage by stage
# ---------------------------------------------------------------------------


def split_stream(image: np.ndarray) -> np.ndarray:
    """The bytes the codec compresses: uint16 as its low-byte plane, then
    its high-byte plane; uint8 as it is."""
    image = np.ascontiguousarray(image)
    if image.dtype == np.uint16:
        flat = image.reshape(-1)
        return np.concatenate([(flat & 0xFF).astype(np.uint8),
                               (flat >> 8).astype(np.uint8)])
    if image.dtype != np.uint8:
        raise ValueError(f"deflate_rle takes uint8/uint16, not {image.dtype}")
    return image.reshape(-1)


def rle_tokens(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``deflate_rle``'s tokens of ``data``: each token's first byte and its
    length (1: a literal; 3..258: a match at distance 1).

    Byte ``i`` of a run that starts at ``r0`` and ends before ``r_end``
    starts a token when it is the run's first byte, when ``i - r0 - 1`` is
    a multiple of 258 (a match of ``min(258, r_end - i)`` if that is 3 or
    more, else a literal), or when it is the run's last byte one past such
    a position (the second of two literals)."""
    n = data.size
    idx = np.arange(n, dtype=np.int64)
    start = np.ones(n, dtype=bool)
    start[1:] = data[1:] != data[:-1]
    r0 = np.maximum.accumulate(np.where(start, idx, 0))
    nxt = np.where(start, idx, n)
    r_end = np.full(n, n, dtype=np.int64)
    r_end[:-1] = np.minimum.accumulate(nxt[:0:-1])[::-1]
    o = idx - r0
    phase = (o - 1) % MAX_MATCH
    rem = r_end - idx
    tok = (o == 0) | ((o > 0) & ((phase == 0) | ((phase == 1) & (rem == 1))))
    match = (o > 0) & (phase == 0) & (rem >= MIN_MATCH)
    length = np.where(match, np.minimum(rem, MAX_MATCH), 1)
    return idx[tok], length[tok]


def slides_by(x: int, n: int) -> int:
    """How many times zlib's window has slid when the token that starts at
    ``x`` is decided (``x == n``: the end of the input), for an input of
    ``n`` bytes given to one ``deflate`` call.

    ``fill_window`` runs before a token whenever 258 or fewer bytes are
    left in the window, and slides by 32 KiB when the token's position in
    the window is 65,274 (``WSIZE + MAX_DIST``) or more. While more input
    waits behind it, the window is full, so slide ``j`` comes at the first
    token at or past ``32768 * (j + 1) - 258``; that holds for the ``ja``
    slides whose window end ``32768 * (j + 1)`` lies before ``n``. The next
    one comes once the window holds the rest of the input, at the first
    token at or past ``n - 258`` and ``32768 * (ja + 2) - 262``, or at the
    end; no later one comes. The kernels use this closed form."""
    ja = max(0, (n - 1) // WSIZE - 1)
    a = min(ja, max(0, (x + MAX_MATCH) // WSIZE - 1))
    if a < ja:
        return a
    edge = WSIZE * (ja + 2)
    return a + 1 if max(n - MAX_MATCH, edge - MIN_LOOKAHEAD) <= x else a


class BlockCode(NamedTuple):
    """One block as ``_tr_flush_block`` sends it."""

    kind: int                 # STORED, STATIC or DYNAMIC
    lit_len: List[int]        # (L_CODES,) code lengths the block's symbols use
    lit_code: List[int]       # bit-reversed codes
    dist_len: List[int]       # (D_CODES,)
    dist_code: List[int]
    bl_len: List[int]         # (BL_CODES,) the bit length tree (dynamic)
    bl_code: List[int]
    max_lcode: int            # largest literal/length code sent (dynamic)
    max_dcode: int
    max_blindex: int          # last index of BL_ORDER sent (dynamic)


class _Trees:
    """The part of zlib's ``deflate_state`` that ``trees.c`` uses for one
    block: the heap (``heap[1..heap_len]`` and, from ``heap_max`` up, the
    nodes in the order they left it), ``depth``, ``bl_count`` and the two
    bit counts. Each method is the function of the same name."""

    def __init__(self):
        self.heap = [0] * HEAP_SIZE
        self.depth = [0] * HEAP_SIZE
        self.bl_count = [0] * (MAX_BITS + 1)
        self.heap_len = 0
        self.heap_max = HEAP_SIZE
        self.opt_len = 0
        self.static_len = 0

    def _smaller(self, freq, n, m) -> bool:
        return freq[n] < freq[m] or (freq[n] == freq[m]
                                     and self.depth[n] <= self.depth[m])

    def pqdownheap(self, freq, k: int) -> None:
        heap = self.heap
        v = heap[k]
        j = k << 1
        while j <= self.heap_len:
            if j < self.heap_len and self._smaller(freq, heap[j + 1], heap[j]):
                j += 1
            if self._smaller(freq, v, heap[j]):
                break
            heap[k] = heap[j]
            k = j
            j <<= 1
        heap[k] = v

    def build_tree(self, freq, elems, stree_len, extra, base, max_length):
        """Code lengths ``(2 * elems + 1,)`` (leaves first) and ``max_code``
        of the tree of ``freq`` (the same size; it gains the internal nodes'
        and any forced leaf's counts, as zlib's tree does)."""
        heap, depth = self.heap, self.depth
        lens = [0] * (2 * elems + 1)
        dad = [0] * (2 * elems + 1)
        self.heap_len = 0
        self.heap_max = HEAP_SIZE
        max_code = -1
        for n in range(elems):
            if freq[n]:
                self.heap_len += 1
                heap[self.heap_len] = max_code = n
                depth[n] = 0
        # at least two codes: the forced ones are 0 or 1, with no extra bits
        while self.heap_len < 2:
            if max_code < 2:
                max_code += 1
                node = max_code
            else:
                node = 0
            self.heap_len += 1
            heap[self.heap_len] = node
            freq[node] = 1
            depth[node] = 0
            self.opt_len -= 1
            if stree_len is not None:
                self.static_len -= stree_len[node]
        for n in range(self.heap_len // 2, 0, -1):
            self.pqdownheap(freq, n)
        node = elems
        while True:
            n = heap[1]                              # pqremove
            heap[1] = heap[self.heap_len]
            self.heap_len -= 1
            self.pqdownheap(freq, 1)
            m = heap[1]
            self.heap_max -= 1
            heap[self.heap_max] = n
            self.heap_max -= 1
            heap[self.heap_max] = m
            freq[node] = freq[n] + freq[m]
            depth[node] = max(depth[n], depth[m]) + 1
            dad[n] = dad[m] = node
            heap[1] = node
            node += 1
            self.pqdownheap(freq, 1)
            if self.heap_len < 2:
                break
        self.heap_max -= 1
        heap[self.heap_max] = heap[1]
        self.gen_bitlen(freq, lens, dad, max_code, stree_len, extra, base,
                        max_length)
        return lens, max_code

    def gen_bitlen(self, freq, lens, dad, max_code, stree_len, extra, base,
                   max_length) -> None:
        heap, bl_count = self.heap, self.bl_count
        for bits in range(MAX_BITS + 1):
            bl_count[bits] = 0
        lens[heap[self.heap_max]] = 0               # the root
        overflow = 0
        for h in range(self.heap_max + 1, HEAP_SIZE):
            n = heap[h]
            bits = lens[dad[n]] + 1
            if bits > max_length:
                bits = max_length
                overflow += 1
            lens[n] = bits
            if n > max_code:
                continue                            # not a leaf
            bl_count[bits] += 1
            xbits = extra[n - base] if n >= base else 0
            f = freq[n]
            self.opt_len += f * (bits + xbits)
            if stree_len is not None:
                self.static_len += f * (stree_len[n] + xbits)
        if overflow == 0:
            return
        while True:
            bits = max_length - 1
            while bl_count[bits] == 0:
                bits -= 1
            bl_count[bits] -= 1
            bl_count[bits + 1] += 2
            bl_count[max_length] -= 1
            overflow -= 2
            if overflow <= 0:
                break
        h = HEAP_SIZE
        for bits in range(max_length, 0, -1):
            n = bl_count[bits]
            while n != 0:
                h -= 1
                m = heap[h]
                if m > max_code:
                    continue
                if lens[m] != bits:
                    self.opt_len += (bits - lens[m]) * freq[m]
                    lens[m] = bits
                n -= 1

    @staticmethod
    def scan_tree(lens, max_code, bl_freq) -> None:
        """Counts the bit length codes that ``send_tree`` will send."""
        lens = list(lens[:max_code + 1]) + [0xFFFF]          # the guard
        prevlen, nextlen, count = -1, lens[0], 0
        max_count, min_count = (138, 3) if nextlen == 0 else (7, 4)
        for n in range(max_code + 1):
            curlen, nextlen = nextlen, lens[n + 1]
            count += 1
            if count < max_count and curlen == nextlen:
                continue
            if count < min_count:
                bl_freq[curlen] += count
            elif curlen != 0:
                if curlen != prevlen:
                    bl_freq[curlen] += 1
                bl_freq[REP_3_6] += 1
            elif count <= 10:
                bl_freq[REPZ_3_10] += 1
            else:
                bl_freq[REPZ_11_138] += 1
            count, prevlen = 0, curlen
            if nextlen == 0:
                max_count, min_count = 138, 3
            elif curlen == nextlen:
                max_count, min_count = 6, 3
            else:
                max_count, min_count = 7, 4


def send_tree(lens, max_code, bl_len, bl_code) -> List[Tuple[int, int]]:
    """The ``(value, bits)`` fields ``send_tree`` writes for one tree."""
    out: List[Tuple[int, int]] = []
    lens = list(lens[:max_code + 1]) + [0xFFFF]
    prevlen, nextlen, count = -1, lens[0], 0
    max_count, min_count = (138, 3) if nextlen == 0 else (7, 4)

    def code(c):
        out.append((bl_code[c], bl_len[c]))

    for n in range(max_code + 1):
        curlen, nextlen = nextlen, lens[n + 1]
        count += 1
        if count < max_count and curlen == nextlen:
            continue
        if count < min_count:
            for _ in range(count):
                code(curlen)
        elif curlen != 0:
            if curlen != prevlen:
                code(curlen)
                count -= 1
            code(REP_3_6)
            out.append((count - 3, 2))
        elif count <= 10:
            code(REPZ_3_10)
            out.append((count - 3, 3))
        else:
            code(REPZ_11_138)
            out.append((count - 11, 7))
        count, prevlen = 0, curlen
        if nextlen == 0:
            max_count, min_count = 138, 3
        elif curlen == nextlen:
            max_count, min_count = 6, 3
        else:
            max_count, min_count = 7, 4
    return out


def block_code(lit_freq, dist_freq, stored_len: int, stored_ok: bool
               ) -> BlockCode:
    """``_tr_flush_block``'s trees and choice for one block: its symbol
    counts (``lit_freq`` without the end code, which is added here),
    its length in bytes, and whether its bytes are still in the window."""
    st = _Trees()
    lfreq = [int(v) for v in lit_freq[:L_CODES]] + [0] * (L_CODES + 1)
    lfreq[END_BLOCK] = 1
    dfreq = [int(v) for v in dist_freq[:D_CODES]] + [0] * (D_CODES + 1)
    lit_len, max_lcode = st.build_tree(lfreq, L_CODES, STATIC_LIT_LEN,
                                       EXTRA_LBITS, 257, MAX_BITS)
    dist_len, max_dcode = st.build_tree(dfreq, D_CODES, [5] * D_CODES,
                                        EXTRA_DBITS, 0, MAX_BITS)
    blfreq = [0] * (2 * BL_CODES + 1)
    st.scan_tree(lit_len, max_lcode, blfreq)
    st.scan_tree(dist_len, max_dcode, blfreq)
    bl_len, _ = st.build_tree(blfreq, BL_CODES, None, EXTRA_BLBITS, 0,
                              MAX_BL_BITS)
    max_blindex = BL_CODES - 1
    while max_blindex >= 3 and bl_len[BL_ORDER[max_blindex]] == 0:
        max_blindex -= 1
    st.opt_len += 3 * (max_blindex + 1) + 5 + 5 + 4
    opt_lenb = (st.opt_len + 3 + 7) >> 3
    static_lenb = (st.static_len + 3 + 7) >> 3
    if static_lenb <= opt_lenb:
        opt_lenb = static_lenb
    if stored_len + 4 <= opt_lenb and stored_ok:
        kind = STORED
    elif static_lenb == opt_lenb:
        kind = STATIC
    else:
        kind = DYNAMIC
    lit_len, dist_len, bl_len = (lit_len[:L_CODES], dist_len[:D_CODES],
                                 bl_len[:BL_CODES])
    return BlockCode(
        kind, lit_len, _canonical_codes(lit_len, max_lcode), dist_len,
        _canonical_codes(dist_len, max_dcode), bl_len,
        _canonical_codes(bl_len, BL_CODES - 1), max_lcode, max_dcode,
        max_blindex,
    )


def _adler32(data: np.ndarray) -> int:
    """Adler-32 as the kernels take it: ``A = 1 + sum(b)``, ``B = n +
    sum((n - i) * b[i])``, both mod 65521, from per-tile sums reduced mod
    65521 (so that no sum overflows 64 bits at any size)."""
    n = data.size
    tile = 4096
    s1 = s2 = 0
    for t0 in range(0, n, tile):
        part = data[t0:t0 + tile].astype(np.uint64)
        ps = int(part.sum())
        s1 += ps
        s2 += (t0 % ADLER_BASE) * (ps % ADLER_BASE) + int(
            (np.arange(part.size, dtype=np.uint64) * part).sum()) % ADLER_BASE
    nm = n % ADLER_BASE
    a = (1 + s1) % ADLER_BASE
    b = (nm + nm * (s1 % ADLER_BASE) + ADLER_BASE - s2 % ADLER_BASE) \
        % ADLER_BASE
    return (b << 16) | a


class _Bits:
    """An LSB-first bit stream of ``(value, bits)`` fields, as zlib's
    ``send_bits`` writes them."""

    def __init__(self):
        self.values: List[np.ndarray] = []
        self.lengths: List[np.ndarray] = []
        self.nbits = 0

    def add(self, values, lengths) -> None:
        values = np.atleast_1d(np.asarray(values, np.uint64))
        lengths = np.broadcast_to(np.asarray(lengths, np.int64),
                                  values.shape)
        self.values.append(values)
        self.lengths.append(lengths)
        self.nbits += int(lengths.sum())

    def align(self) -> None:
        """``bi_windup``: zero bits up to the next byte."""
        self.add(0, -self.nbits % 8)

    def tobytes(self) -> bytes:
        self.align()
        values = np.concatenate(self.values)
        lengths = np.concatenate(self.lengths)
        keep = lengths > 0
        values, lengths = values[keep], lengths[keep]
        starts = np.cumsum(lengths) - lengths
        shift = (np.arange(self.nbits, dtype=np.int64)
                 - np.repeat(starts, lengths)).astype(np.uint64)
        bits = (np.repeat(values, lengths) >> shift) & np.uint64(1)
        return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def deflate_rle_plain(data: np.ndarray) -> bytes:
    """``zlib.compressobj(1, DEFLATED, 15, 9, Z_RLE)`` of ``data`` (uint8),
    header, blocks and trailer, computed stage by stage as the kernels
    compute it."""
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = data.size
    pos, length = rle_tokens(data)
    ntok = pos.size
    is_match = length >= MIN_MATCH
    lcode = LENGTH_CODE[np.where(is_match, length - MIN_MATCH, 0)]
    sym = np.where(is_match, 257 + lcode, data[pos] if n else 0)
    xbits = np.where(is_match, np.asarray(EXTRA_LBITS)[lcode], 0)
    xval = np.where(is_match, length - MIN_MATCH - BASE_LENGTH[lcode], 0)
    nblocks = ntok // BLOCK_TOKENS + 1
    out = _Bits()
    for b in range(nblocks):
        t0, t1 = b * BLOCK_TOKENS, min((b + 1) * BLOCK_TOKENS, ntok)
        last = b == nblocks - 1
        start = int(pos[t0]) if t0 < ntok else n
        end = int(pos[t1]) if t1 < ntok else n
        # the window's state when the block is flushed: after its last
        # token was decided, or at the end of the input for the last block
        x = n if last else int(pos[t1 - 1])
        stored_ok = start >= WSIZE * slides_by(x, n)
        bsym, bmatch = sym[t0:t1], is_match[t0:t1]
        lit_freq = np.bincount(bsym, minlength=L_CODES)
        dist_freq = np.zeros(D_CODES, np.int64)
        dist_freq[0] = int(bmatch.sum())
        code = block_code(lit_freq, dist_freq, end - start, stored_ok)
        out.add(code.kind << 1 | last, 3)
        if code.kind == STORED:
            out.align()
            ln = end - start
            out.add([ln & 0xFFFF, ~ln & 0xFFFF], 16)
            out.add(data[start:end], 8)
            continue
        if code.kind == DYNAMIC:
            out.add([code.max_lcode + 1 - 257, code.max_dcode + 1 - 1,
                     code.max_blindex + 1 - 4], [5, 5, 4])
            out.add([code.bl_len[BL_ORDER[r]]
                     for r in range(code.max_blindex + 1)], 3)
            for lens, mc in ((code.lit_len, code.max_lcode),
                             (code.dist_len, code.max_dcode)):
                fields = send_tree(lens, mc, code.bl_len, code.bl_code)
                out.add([f[0] for f in fields], [f[1] for f in fields])
            lit_len, lit_code = code.lit_len, code.lit_code
            dist_len0, dist_code0 = code.dist_len[0], code.dist_code[0]
        else:
            lit_len, lit_code = STATIC_LIT_LEN, STATIC_LIT_CODE
            dist_len0, dist_code0 = 5, STATIC_DIST_CODE[0]
        lit_len = np.asarray(lit_len, np.int64)
        lit_code = np.asarray(lit_code, np.uint64)
        # each token: its code, its extra length bits, the distance code
        vals = np.stack([lit_code[bsym], xval[t0:t1].astype(np.uint64),
                         np.full(t1 - t0, dist_code0, np.uint64)], 1)
        lens = np.stack([lit_len[bsym], xbits[t0:t1],
                         np.where(bmatch, dist_len0, 0)], 1)
        out.add(vals.reshape(-1), lens.reshape(-1))
        out.add(int(lit_code[END_BLOCK]), int(lit_len[END_BLOCK]))
    return ZLIB_HEADER + out.tobytes() + struct.pack(">I", _adler32(data))


def sdfl_header(image_shape, dtype) -> bytes:
    """The deflate codec's 13-byte header for an image of this shape."""
    return SDFL_MAGIC + struct.pack(">BII", SDFL_CODES[np.dtype(dtype)],
                                    *image_shape)


def encode_plain(image: np.ndarray) -> bytes:
    """``DeflateCodec.encode(image)``, computed by the plain version."""
    image = np.asarray(image)
    if image.ndim != 2:
        raise ValueError("deflate_rle encodes a 2-D image")
    return sdfl_header(image.shape, image.dtype) + deflate_rle_plain(
        split_stream(image))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check_image(t: torch.Tensor) -> None:
    if t.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"deflate_rle takes uint8/uint16, not {t.dtype}")
    if t.dim() != 2 or not t.is_contiguous() or t.numel() < 1:
        raise ValueError("deflate_rle takes a contiguous, non-empty 2-D image")


def max_stream_bytes() -> int:
    """The longest stream the kernels take (2 bytes a pixel for uint16):
    beyond it a token's bit offset would leave 32 bits."""
    return int(library().deflate_rle_max_stream())


def queue_device(stego: torch.Tensor) -> Callable[[], memoryview]:
    """Queues :func:`encode_device`'s memset and three launches on the
    current stream and returns the function that reads the length back,
    then exactly that many bytes, as a read-only view of the downloaded
    array (a 2048x2048 stream is 5.7 MB: copying it into ``bytes`` took
    longer than the copy from the card): the host may work in between."""
    _check_image(stego)
    h, w = stego.shape
    n, item = h * w, stego.element_size()
    if n * item > max_stream_bytes():
        raise ValueError(f"a {h}x{w} {stego.dtype} stream exceeds the "
                         f"deflate kernels' {max_stream_bytes()} bytes")
    lib = library()
    size = lib.deflate_rle_buffer_bytes(n, item)
    off = lib.deflate_rle_out_offset(n, item)
    buf = torch.empty(size, dtype=torch.uint8, device=stego.device)
    fn = lib.deflate_rle_u8 if item == 1 else lib.deflate_rle_u16
    err = fn(stego.data_ptr(), n, h, w, buf.data_ptr(), size,
             stream_ptr(stego))
    check(lib, err, "deflate_rle")
    for kernel in KERNELS:
        profiling.count("launch." + kernel)

    def result() -> memoryview:
        length = int(download(buf[:8].view(torch.int64))[0])
        return memoryview(download(buf[off:off + length])).toreadonly()

    return result


def encode_device(stego: torch.Tensor) -> bytes:
    """``DeflateCodec.encode`` of a CUDA image by the kernels."""
    return bytes(queue_device(stego)())


# ---------------------------------------------------------------------------
# the route: the kernels where this process's zlib gives their bytes
# ---------------------------------------------------------------------------


def _lcg_bytes(n: int, seed: int) -> np.ndarray:
    """Fixed pseudo-random bytes (no generator state involved)."""
    x = (seed + np.arange(n, dtype=np.uint64) * np.uint64(2654435761)) \
        & np.uint64(0xFFFFFFFF)
    x = (x * np.uint64(1103515245) + np.uint64(12345)) & np.uint64(0xFFFFFFFF)
    return (x >> np.uint64(16)).astype(np.uint8)


def probe_images() -> List[np.ndarray]:
    """The probe: images whose streams hold a stored block, a stored
    candidate that the window's slide forces to Huffman, dynamic blocks, a
    static block, runs of 257-261 and 516 bytes, an empty last block and a
    uint16 stream whose runs cross the split."""
    noise = _lcg_bytes(70000, 1)
    runs = []
    for k, r in enumerate((257, 258, 259, 260, 261, 516)):
        runs += [np.full(r, 40 + k, np.uint8), _lcg_bytes(3, 100 + k)]
    a = np.concatenate([noise] + runs)
    # 2 * 32767 literals: the last block holds no token
    b = _lcg_bytes(2 * BLOCK_TOKENS, 7)
    c = np.full((7, 9), 0x0312, np.uint16)
    c[3, 2:] = 0x0800
    # the low plane ends in a run of zeros that the high plane continues
    d = np.arange(96 * 97, dtype=np.uint16) // 37 % 5 * 0x0101
    d[-300:] = 0x0300
    d = d.reshape(96, 97)
    return [a.reshape(1, -1), b.reshape(1, -1), c, d,
            _lcg_bytes(5, 3).reshape(1, 5)]


def _host_encode(image: np.ndarray) -> bytes:
    from ..io.codecs import get as get_codec

    return get_codec("deflate").encode(image)


@functools.lru_cache(maxsize=None)
def _route_ok(index: int) -> bool:
    dev = torch.device("cuda", index)
    return all(encode_device(upload(image, dev)) == _host_encode(image)
               for image in probe_images())


def check_device_route(device: torch.device) -> None:
    """Raises where the kernels would not give this process's zlib bytes: at
    the first use in a process, they and the host codec compress
    :func:`probe_images` on ``device`` (CUDA) and must agree byte for byte."""
    if not _route_ok(torch.device(device).index or 0):
        raise RuntimeError(
            f"the deflate kernels give other bytes than this process's zlib "
            f"{zlib.ZLIB_RUNTIME_VERSION} on their probe, so the containers "
            f"of a CUDA stego would differ from the host codec's")


def transport_encode(codec, stego: np.ndarray,
                     stego_dev: Optional[torch.Tensor]
                     ) -> Callable[[], Union[bytes, memoryview]]:
    """``codec.encode(stego)``, where ``stego_dev`` is the same image on its
    device or None, as a function that gives the bytes (for the
    container's concatenation: ``bytes`` or a read-only view): the ``deflate``
    codec's encode of a CUDA image is queued on the card
    (:func:`queue_device`, after :func:`check_device_route`), so the caller
    can do host work before it asks for them; any other codec, device or
    image is encoded by the host codec at once."""
    if codec.name == "deflate":
        if stego_dev is not None and stego_dev.device.type == "cuda":
            check_device_route(stego_dev.device)
            profiling.count("codec.deflate_device")
            return queue_device(stego_dev)
        profiling.count("codec.deflate_host")
    blob = codec.encode(stego)
    return lambda: blob
