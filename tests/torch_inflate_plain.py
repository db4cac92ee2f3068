"""The plain version of the inflate kernels
(``codec_tcc_tpu_torch/csrc/inflate.cu``): their spec stage by stage in
NumPy, which the CPU tests hold to zlib and hold the kernels' routines
(built for the host from ``torch_inflate_host.cpp``) to, status for status
and count for count.

* **Scan.** An offset is a *candidate* when the three bits there read
  BTYPE 10, HLIT and HDIST are in range (at most 286 and 30 codes), the
  code length code is complete, the code lengths it codes repeat nothing
  before the first and run past no end, and the literal/length and
  distance codes they give are complete with a non-zero end code
  (:func:`dynamic_header`; :func:`scan_plain` tests every offset at once).
  zlib's own dynamic blocks always pass (their trees have two codes or
  more); other offsets rarely do.
* **Measure.** Each candidate decodes to its end code without writing,
  and records where it ends, its bytes (a leading repeat of the byte
  before the block left open), and whether a distance other than 1 or a
  broken code came up (:func:`decode_block`).
* **Chain.** From bit 16, after the zlib header, one walk reads each
  block's header: a stored block is placed from its ``LEN``/``NLEN``; a
  dynamic block takes the candidate that starts exactly there; a fixed
  block, or a dynamic header whose candidate is missing, failed or past
  the cap, is decoded on the walk itself (*serial* blocks). The walk
  requires BFINAL on the last block, the exact length the SDFL header
  commits to, and the four trailer bytes.
* **Emit.** The blocks' bytes in order, Adler-32 compared with the
  trailer (:func:`_adler32`, from the two sums the kernel keeps).

The status words are ``ops/inflate.py``'s ``STATUS``: a stream that zlib
may decode and the kernels do not (a distance other than 1, or a Huffman
code that zlib takes incomplete: :func:`foreign_header`) reads
``FOREIGN``; every other fault reads a status that zlib refuses too.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from codec_tcc_tpu_torch.ops.deflate_rle import (ADLER_BASE, BL_ORDER,
                                                 EXTRA_DBITS, EXTRA_LBITS)
from codec_tcc_tpu_torch.ops.inflate import (ADLER, BROKEN, FOREIGN, LENGTH,
                                             OK, SDFL_HEADER, sdfl_fields)

_BROKEN, _FOREIGN, _LENGTH, _ADLER = BROKEN, FOREIGN, LENGTH, ADLER

MAX_TOKENS = 1 << 16             # a candidate's tokens before it is refused
BASE_LENGTH = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35,
               43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
BASE_DIST = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
             385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
             16385, 24577)
FIXED_LIT = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
FIXED_DIST = [5] * 32


class _Bits:
    """LSB-first reads of a byte string; zero past its end (as the
    kernels' padded buffer reads)."""

    def __init__(self, data: bytes):
        self.data = bytes(data) + bytes(16)
        self.nbits = 8 * len(data)

    def get(self, pos: int, n: int) -> int:
        b = pos >> 3
        word = int.from_bytes(self.data[b:b + 8], "little") if b < len(
            self.data) else 0
        return (word >> (pos & 7)) & ((1 << n) - 1)


def _kraft(lens, max_bits: int) -> int:
    """Sum of ``2**(max_bits - l)`` over the non-zero lengths: the code is
    complete when it is ``2**max_bits``."""
    return sum(1 << (max_bits - ln) for ln in lens if ln)


def _lut(lens, max_bits: int) -> List[Tuple[int, int]]:
    """Every ``max_bits``-bit LSB-first pattern to ``(symbol, length)`` of
    the canonical code of ``lens`` (a complete code: every pattern maps)."""
    count = [0] * 16
    for ln in lens:
        count[ln] += 1
    count[0] = 0
    nxt, code = [0] * 16, 0
    for ln in range(1, 16):
        code = (code + count[ln - 1]) << 1
        nxt[ln] = code
    table = [(-1, 0)] * (1 << max_bits)
    for sym, ln in enumerate(lens):
        if not ln:
            continue
        c = nxt[ln]
        nxt[ln] += 1
        rev = int(format(c, f"0{ln}b")[::-1], 2)
        for fill in range(rev, 1 << max_bits, 1 << ln):
            table[fill] = (sym, ln)
    return table


class _Tables(NamedTuple):
    lit: list             # 15-bit LUT: (symbol, length)
    dist: list
    data_bit: int         # first bit after the header and code lengths


def _code_lengths(r: _Bits, p: int):
    """``(literal/length lengths, distance lengths, first data bit)`` of the
    dynamic header at bit ``p``, or None where it does not parse: HLIT or
    HDIST out of range, a code length code that is not complete, a repeat
    before the first length or past the last."""
    if r.get(p + 1, 2) != 2:
        return None
    hlit, hdist, hclen = r.get(p + 3, 5), r.get(p + 8, 5), r.get(p + 13, 4)
    if hlit > 29 or hdist > 29:
        return None
    cl = [0] * 19
    q = p + 17
    for i in range(hclen + 4):
        cl[BL_ORDER[i]] = r.get(q, 3)
        q += 3
    if _kraft(cl, 7) != 1 << 7:
        return None
    cl_lut = _lut(cl, 7)
    total, lens = hlit + 257 + hdist + 1, []
    while len(lens) < total:
        sym, ln = cl_lut[r.get(q, 7)]
        q += ln
        if sym < 16:
            lens.append(sym)
            continue
        if sym == 16:
            if not lens:
                return None
            rep, val = 3 + r.get(q, 2), lens[-1]
            q += 2
        elif sym == 17:
            rep, val = 3 + r.get(q, 3), 0
            q += 3
        else:
            rep, val = 11 + r.get(q, 7), 0
            q += 7
        if len(lens) + rep > total:
            return None
        lens += [val] * rep
    return lens[:hlit + 257], lens[hlit + 257:], q


def dynamic_header(r: _Bits, p: int) -> Optional[_Tables]:
    """The tables of the dynamic block whose 3-bit header is at bit ``p``,
    or None where the predicate that picks candidates fails there."""
    parsed = _code_lengths(r, p)
    if parsed is None:
        return None
    lit, dist, q = parsed
    if not lit[256] or _kraft(lit, 15) != 1 << 15 \
            or _kraft(dist, 15) != 1 << 15:
        return None
    return _Tables(_lut(lit, 15), _lut(dist, 15), q)


def foreign_header(r: _Bits, p: int) -> bool:
    """Whether the dynamic header at bit ``p`` fails the predicate only on
    a code that zlib takes incomplete: a single 1-bit code, or no distance
    code at all (the kernels leave such a stream to zlib)."""
    parsed = _code_lengths(r, p)
    if parsed is None or not parsed[0][256]:
        return False
    lit, dist, _ = parsed

    def zlib_takes(lens, empty_ok):
        n, k = sum(1 for ln in lens if ln), _kraft(lens, 15)
        return k == 1 << 15 or (n == 1 and k == 1 << 14) or (
            empty_ok and n == 0)

    complete = _kraft(lit, 15) == _kraft(dist, 15) == 1 << 15
    return not complete and zlib_takes(lit, False) and zlib_takes(dist, True)


def _fixed_tables(p: int) -> _Tables:
    return _Tables(_lut(FIXED_LIT, 15), _lut(FIXED_DIST, 15), p + 3)


def _field(bits: np.ndarray, pos: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(pos.shape, np.int64)
    for j in range(n):
        out |= bits[pos + j].astype(np.int64) << j
    return out


def scan_plain(stream: bytes, first: int = 16,
               chunk: int = 1 << 22) -> np.ndarray:
    """Every bit offset from ``first`` on where :func:`dynamic_header`
    holds, vectorised over the offsets as the scan kernel runs one thread
    per offset: the cheap tests first (BTYPE, HLIT, HDIST, the code length
    code's completeness), then the code lengths decoded in lock step for
    the offsets left."""
    nbits = 8 * len(stream)
    pad = 17 + 19 * 3 + 316 * 14 + 64
    bits = np.unpackbits(np.frombuffer(bytes(stream) + bytes(pad // 8 + 1),
                                       np.uint8), bitorder="little")
    found = []
    for c0 in range(first, nbits, chunk):
        p = np.arange(c0, min(c0 + chunk, nbits), dtype=np.int64)
        p = p[(bits[p + 1] == 0) & (bits[p + 2] == 1)]
        hlit, hdist = _field(bits, p + 3, 5), _field(bits, p + 8, 5)
        keep = (hlit <= 29) & (hdist <= 29)
        p, hlit, hdist = p[keep], hlit[keep], hdist[keep]
        hclen = _field(bits, p + 13, 4)
        cl = np.zeros((p.size, 19), np.int64)
        for i in range(19):
            cl[:, BL_ORDER[i]] = np.where(i < hclen + 4,
                                          _field(bits, p + 17 + 3 * i, 3), 0)
        kraft = np.where(cl > 0, 1 << np.maximum(7 - cl, 0), 0).sum(1)
        keep = kraft == 1 << 7
        if keep.any():
            found.append(_scan_lengths(bits, p[keep], hlit[keep],
                                       hdist[keep], hclen[keep], cl[keep]))
    return np.concatenate(found) if found else np.zeros(0, np.int64)


def _scan_lengths(bits, p, hlit, hdist, hclen, cl) -> np.ndarray:
    """The code lengths of each offset left, one code length symbol a step
    for all of them: completeness of both codes and the end code."""
    m = p.size
    # the code length code's table, 7-bit patterns to symbol and length
    lut_sym = np.zeros((m, 128), np.int64)
    lut_len = np.zeros((m, 128), np.int64)
    count = np.stack([(cl == ln).sum(1) for ln in range(8)], 1)
    count[:, 0] = 0
    nxt = np.zeros((m, 8), np.int64)
    code = np.zeros(m, np.int64)
    for ln in range(1, 8):
        code = (code + count[:, ln - 1]) << 1
        nxt[:, ln] = code
    rows = np.arange(m)
    step = np.arange(128)
    for sym in range(19):
        ln = cl[:, sym]
        c = nxt[rows, ln]
        nxt[rows, ln] += ln > 0
        rev = np.zeros(m, np.int64)
        for j in range(7):
            rev |= np.where(j < ln, ((c >> j) & 1) << np.maximum(ln - 1 - j, 0),
                            0)
        fill = rev[:, None] + step[None, :] * (1 << ln)[:, None]
        r, k = np.nonzero((ln[:, None] > 0) & (fill < 128))
        lut_sym[r, fill[r, k]] = sym
        lut_len[r, fill[r, k]] = ln[r]
    nlen, total = hlit + 257, hlit + 257 + hdist + 1
    q = p + 17 + 3 * (hclen + 4)
    have = np.zeros(m, np.int64)
    prev = np.full(m, -1, np.int64)
    lit_k = np.zeros(m, np.int64)
    dist_k = np.zeros(m, np.int64)
    eob = np.zeros(m, np.int64)
    alive = np.ones(m, bool)
    while True:
        act = alive & (have < total)
        if not act.any():
            break
        i = np.flatnonzero(act)
        pat = _field(bits, q[i], 7)
        sym, ln = lut_sym[i, pat], lut_len[i, pat]
        q[i] += ln
        rep = np.ones(i.size, np.int64)
        val = sym.copy()
        r16, r17, r18 = sym == 16, sym == 17, sym == 18
        rep[r16] = 3 + _field(bits, q[i[r16]], 2)
        rep[r17] = 3 + _field(bits, q[i[r17]], 3)
        rep[r18] = 11 + _field(bits, q[i[r18]], 7)
        q[i] += np.where(r16, 2, 0) + np.where(r17, 3, 0) + np.where(r18, 7, 0)
        val[r16] = prev[i[r16]]
        val[r17 | r18] = 0
        bad = (r16 & (have[i] == 0)) | (have[i] + rep > total[i])
        alive[i[bad]] = False
        ok = ~bad
        i, rep, val = i[ok], rep[ok], val[ok]
        h0, h1 = have[i], have[i] + rep
        in_lit = np.clip(np.minimum(h1, nlen[i]) - h0, 0, None)
        weight = np.where(val > 0, 1 << np.maximum(15 - val, 0), 0)
        lit_k[i] += in_lit * weight
        dist_k[i] += (rep - in_lit) * weight
        at_eob = (h0 <= 256) & (256 < h1)
        eob[i[at_eob]] = val[at_eob]
        have[i] = h1
        prev[i] = val
    keep = alive & (lit_k == 1 << 15) & (dist_k == 1 << 15) & (eob > 0)
    return p[keep]


class Block(NamedTuple):
    """One block as the measure pass (or the walk) leaves it."""

    end: int              # first bit after its end code
    out: list             # its bytes; None where a match repeats the byte
                          # before the block
    far: bool             # a distance other than 1 came up
    broken: bool          # a code that decodes to nothing valid, a match
                          # with no byte before it, or it ran off the end


def decode_block(r: _Bits, t: _Tables, limit: int,
                 max_tokens: Optional[int] = None) -> Block:
    """A Huffman block from its first data bit to its end code, as the
    measure pass decodes it: bytes that repeat the byte before the block
    are None, so that one pass serves every predecessor."""
    q, out, tokens = t.data_bit, [], 0
    while True:
        if q > r.nbits or len(out) > limit or (
                max_tokens is not None and tokens > max_tokens):
            return Block(q, out, False, True)
        tokens += 1
        sym, ln = t.lit[r.get(q, 15)]
        q += ln
        if sym < 256:
            out.append(sym)
            continue
        if sym == 256:
            return Block(q, out, False, False)
        if sym > 285:
            return Block(q, out, False, True)
        k = sym - 257
        length = BASE_LENGTH[k] + r.get(q, EXTRA_LBITS[k])
        q += EXTRA_LBITS[k]
        dsym, dl = t.dist[r.get(q, 15)]
        q += dl
        if dsym > 29:
            return Block(q, out, False, True)
        dist = BASE_DIST[dsym] + r.get(q, EXTRA_DBITS[dsym])
        q += EXTRA_DBITS[dsym]
        if dist != 1:
            return Block(q, out, True, False)
        out += [out[-1] if out else None] * length


def _adler32(raw: np.ndarray) -> int:
    """Adler-32 from the two sums the emit pass keeps: ``S1 = sum b`` and
    ``S2 = sum i * b`` over the byte index ``i``."""
    raw = raw.astype(np.uint64)
    n = raw.size
    s1 = int(raw.sum())
    s2 = int((np.arange(n, dtype=np.uint64) * raw).sum())
    a = (1 + s1) % ADLER_BASE
    nm = n % ADLER_BASE
    b = (nm + nm * (s1 % ADLER_BASE) + ADLER_BASE - s2 % ADLER_BASE) \
        % ADLER_BASE
    return b << 16 | a


class Plain(NamedTuple):
    status: int
    raw: Optional[np.ndarray]    # the inflated bytes where status is OK
    candidates: int
    blocks: int
    serial: int


def inflate_plain(blob, cap: Optional[int] = None) -> Plain:
    """The kernels' result for a deflate payload (SDFL header included)
    that ``sdfl_fields`` takes: the status, the inflated bytes in stream
    order where it is ``OK``, and the counts. ``cap`` is the kernels' limit
    on the candidates the measure takes (the first of ``limits``; None
    lifts it): the blocks of the candidates past it are decoded on the
    walk, as the chain decodes them."""
    code, h, w = sdfl_fields(blob)
    want = h * w * (2 if code == 3 else 1)
    stream = bytes(blob[SDFL_HEADER:])
    r = _Bits(stream)
    cands = scan_plain(stream)
    ncand = int(cands.size)
    measured = {}
    for p in cands.tolist()[:cap]:
        t = dynamic_header(r, p)
        measured[p] = decode_block(r, t, want, MAX_TOKENS)

    def result(status, raw=None):
        return Plain(status, raw, ncand, len(outs), serial)

    # the walk: each block's bytes, leading repeats of the byte before it
    # resolved as the emit pass resolves them
    p, outs, serial, total, last = 16, [], 0, 0, None
    while True:
        final, btype = r.get(p, 1), r.get(p + 1, 2)
        if btype == 0:
            q = (p + 3 + 7) & ~7
            ln, nln = r.get(q, 16), r.get(q + 16, 16)
            b0 = q // 8 + 4
            if q + 32 > r.nbits or ln != (~nln & 0xFFFF) \
                    or 8 * (b0 + ln) > r.nbits:
                return result(_BROKEN)
            out = list(stream[b0:b0 + ln])
            p = 8 * (b0 + ln)
        elif btype == 3:
            return result(_BROKEN)
        else:
            blk = measured.get(p) if btype == 2 else None
            if blk is None or blk.broken:
                serial += 1
                t = _fixed_tables(p) if btype == 1 else dynamic_header(r, p)
                if t is None:
                    return result(_FOREIGN if foreign_header(r, p)
                                  else _BROKEN)
                blk = decode_block(r, t, want)
            if blk.far:
                return result(_FOREIGN)
            opens = bool(blk.out) and blk.out[0] is None
            if blk.broken or blk.end > r.nbits or (opens and last is None):
                return result(_BROKEN)
            out = [last if v is None else v for v in blk.out]
            p = blk.end
        outs.append(out)
        total += len(out)
        if out:
            last = out[-1]
        if total > want:
            return result(_LENGTH)
        if final:
            break
    if total != want:
        return result(_LENGTH)
    tail = (p + 7) // 8
    if tail + 4 > len(stream):
        return result(_BROKEN)
    raw = np.fromiter((v for out in outs for v in out), np.uint8, total)
    if _adler32(raw) != int.from_bytes(stream[tail:tail + 4], "big"):
        return result(_ADLER)
    return result(OK, raw)
