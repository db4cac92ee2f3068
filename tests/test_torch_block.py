"""Strategy ``block_adaptive`` in the port against the JAX package, on the
CPU: the copied host modules are the same code, and the port's one torch
formulation of the block embed and of the device block extract equals
every route of the JAX package's (the one-hot matmul route of uniform
tilings with and without host pre-sliced ``msg_rows``, and the clipped
gather route, which edge tilings take and which is forced here on uniform
ones too) and ``extract_block_host``, exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codec_tcc_tpu.ops import embed as jax_embed
from codec_tcc_tpu.ops import host_embed as jax_host_embed
from codec_tcc_tpu.ops import host_extract as jax_host_extract
from codec_tcc_tpu.parallel import batch as jax_batch
from codec_tcc_tpu_torch.ops import blocks as block_ops
from codec_tcc_tpu_torch.ops import embed as torch_embed
from codec_tcc_tpu_torch.ops import host_embed as torch_host_embed
from codec_tcc_tpu_torch.ops import host_extract as torch_host_extract
from codec_tcc_tpu_torch.ops import segments as segment_ops
from codec_tcc_tpu_torch.parallel import batch as torch_batch
from codec_tcc_tpu_torch.pipeline import _plane_bucket

from torch_parity import same_code

torch.set_num_threads(1)


# (h, w, block): uniform tilings at two block sizes, edge tiles on both
# axes, edge tiles at block 12, and one tile larger than the image
GEOMETRIES = [(64, 64, 4), (64, 64, 8), (40, 41, 8), (61, 67, 12), (5, 7, 8)]
GRID = [(h, w, b, dt, s) for h, w, b in GEOMETRIES
        for dt in (np.uint8, np.uint16)
        for s in (0, 1, 4, 8, 16) if s <= 8 * np.dtype(dt).itemsize]
# out_len of the JAX package's extract at each cut point (one XLA compile
# per test); the port is held to extract_block_host at all three
OUT_LEN = {0: 37, 1: 1000, 4: 1024, 8: 37, 16: 1000}


@pytest.mark.parametrize("port_obj,jax_obj", [
    (torch_host_extract, jax_host_extract),
    (torch_host_extract.extract_raster_host,
     jax_host_extract.extract_raster_host),
    (torch_host_extract.block_counts_host, jax_host_extract.block_counts_host),
    (torch_host_extract.block_fill_positions_host,
     jax_host_extract.block_fill_positions_host),
    (torch_host_extract.extract_block_host,
     jax_host_extract.extract_block_host),
    (torch_host_embed.embed_raster_host_packed,
     jax_host_embed.embed_raster_host_packed),
    (torch_batch.hybrid_base_offsets_host, jax_batch.hybrid_base_offsets_host),
], ids=["host_extract", "extract_raster_host", "block_counts_host",
        "block_fill_positions_host", "extract_block_host",
        "embed_raster_host_packed", "hybrid_base_offsets_host"])
def test_copied_host_code_is_unchanged(port_obj, jax_obj):
    assert same_code(port_obj, jax_obj)


def _image(rng, h, w, dtype):
    hi = 1 << (8 * np.dtype(dtype).itemsize)
    return rng.integers(0, hi, (h, w)).astype(dtype)


def _bases(img, nbits, s, block):
    """The pipeline's base table from ``img``'s tile popcounts: rows below
    ``s`` from ``block_base_offsets``, zero rows past it; and the rankings
    that ``extract_block_host`` takes."""
    h, w = img.shape
    counts = torch_host_extract.block_counts_host(img, s, block)
    ntiles = counts[0].size if s else (-(-h // block)) * (-(-w // block))
    base = np.zeros((nbits, ntiles), np.int32)
    rankings = []
    for p in range(s):
        b, ranking = block_ops.block_base_offsets(counts[p], h, w, block)
        base[p] = b
        rankings.append(ranking)
    return base, rankings


def _plans(rng, s, n, nbits):
    """(label, seg_len, msg_off, msg bits): the pipeline's plans for
    payloads of 0 bits, 304 bits and at capacity, and a degenerate plan
    with aliased offsets, a window longer than N and nonzero lengths on the
    planes past ``s``."""
    plans = []
    totals = (("empty", 0), ("text", 304),
              ("capacity", segment_ops.usable_capacity_bits(s, n, 42))
              ) if s else ()
    for label, total in totals:
        plan = segment_ops.distribute_segments(s, total, 42)
        pp = segment_ops.raster_plane_plan(plan, n, nbits, 0, True)
        msg = rng.integers(0, 2, total).astype(np.uint8)
        plans.append((label, pp.lengths, pp.offsets, msg))
    seg_len = rng.integers(1, n + 1, nbits).astype(np.int32)
    seg_len[0] = n + 5
    msg_off = np.full(nbits, int(rng.integers(0, n)), np.int32)
    msg_off[1::3] = 3
    msg = rng.integers(0, 2, int(msg_off.max()) + n).astype(np.uint8)
    plans.append(("aliased_past_s", seg_len, msg_off, msg))
    return plans


def _gather_route(monkeypatch, fn, static_argnums, *args):
    """``fn`` (a jitted function of ``jax_embed``) traced afresh with
    ``_uniform_tiling`` false: the clipped gather route, which edge tilings
    take, on any geometry."""
    with monkeypatch.context() as m:
        m.setattr(jax_embed, "_uniform_tiling", lambda *a: False)
        return jax.jit(fn.__wrapped__, static_argnums=static_argnums)(*args)


def _jax_embed_routes(monkeypatch, img, msg_pad, base, seg_len, msg_off, s,
                      nbits, block):
    """The JAX package's embed by each route that applies to the geometry."""
    h, w = img.shape
    args = (jnp.asarray(img), jnp.asarray(msg_pad), jnp.asarray(base),
            jnp.asarray(seg_len), jnp.asarray(msg_off), jnp.int32(s))
    routes = {"natural": jax_embed.embed_block_adaptive(*args, nbits, block)}
    if h % block == 0 and w % block == 0:
        rows = jax_embed.block_msg_rows(msg_pad, msg_off, nbits, h, w, block)
        routes["msg_rows"] = jax_embed.embed_block_adaptive(
            *args, nbits, block, jnp.asarray(rows))
        routes["gather"] = _gather_route(
            monkeypatch, jax_embed.embed_block_adaptive, (6, 7),
            *args, nbits, block)
    return {k: np.asarray(v) for k, v in routes.items()}


@pytest.mark.parametrize("h,w,block,dtype,s", GRID)
def test_embed_block_adaptive_matches_jax(monkeypatch, h, w, block, dtype, s):
    rng = np.random.default_rng(h * w + s)
    n = h * w
    nbits = _plane_bucket(s, 8 * np.dtype(dtype).itemsize)
    img = _image(rng, h, w, dtype)
    base, _ = _bases(img, nbits, s, block)
    plans = _plans(rng, s, n, nbits)
    # the JAX package reads the pipeline's zero-padded message (padded
    # further, as its pipeline pads to a power of two: one length, one
    # compile); the port reads the message itself, bits past its end as 0
    lpad = max(int(off.max()) + n for _, _, off, _ in plans)
    for label, seg_len, msg_off, msg in plans:
        msg_pad = torch_embed.pad_message(msg, n, lpad - n)
        got = torch_embed.embed_block_adaptive(
            torch.from_numpy(img), torch.from_numpy(msg), base, seg_len,
            msg_off, s, nbits, block).numpy()
        routes = _jax_embed_routes(monkeypatch, img, msg_pad, base, seg_len,
                                   msg_off, s, nbits, block)
        for route, want in routes.items():
            np.testing.assert_array_equal(got, want, err_msg=f"{label} {route}")
        if s == 0:
            np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("h,w,block,dtype,s", GRID)
def test_extract_block_message_device_matches_jax_and_host(
        monkeypatch, h, w, block, dtype, s):
    rng = np.random.default_rng(7 * h * w + s)
    n = h * w
    nbits = _plane_bucket(s, 8 * np.dtype(dtype).itemsize)
    stego = _image(rng, h, w, dtype)
    base, rankings = _bases(stego, nbits, s, block)
    uniform = h % block == 0 and w % block == 0
    jax_len = OUT_LEN[s]
    for label, seg_len, msg_off, _ in _plans(rng, s, n, nbits):
        for out_len in (37, 1000, 1024):
            got = torch_embed.extract_block_message_device(
                torch.from_numpy(stego), base, seg_len, msg_off, s, nbits,
                block, out_len).numpy()
            what = f"{label} out_len={out_len}"
            host = torch_host_extract.extract_block_host(
                stego, rankings, seg_len, msg_off, s, block, out_len)
            np.testing.assert_array_equal(got, host, err_msg=f"{what} host")
            if out_len != jax_len:
                continue
            args = (jnp.asarray(stego), jnp.asarray(base),
                    jnp.asarray(seg_len), jnp.asarray(msg_off), jnp.int32(s))
            want = jax_embed.extract_block_message_device(
                *args, nbits, block, out_len)
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=what)
            if uniform:
                aligned = _gather_route(
                    monkeypatch, jax_embed.extract_block_aligned, (4, 5),
                    args[0], args[1], args[2], args[4], nbits, block)
                want = jax_embed.assemble_message_device(
                    aligned, args[3], args[2], out_len)
                np.testing.assert_array_equal(got, np.asarray(want),
                                              err_msg=f"{what} gather")


def test_past_cut_plane_overwrites_with_zeros():
    """A plane past the cut point with a nonzero length aliasing an earlier
    plane's window writes zeros there (the JAX package's own pin of this
    case, tests/test_block_mxu_round5.py), in the port's device extract
    and in the host twin alike."""
    rng = np.random.default_rng(12)
    block, h, w = 4, 16, 16
    nbits, s = 3, 1
    stego = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    ntiles = (h // block) * (w // block)
    bases = np.stack([rng.permutation(ntiles).astype(np.int32) * block * block
                      for _ in range(nbits)])
    seg_len = np.array([50, 30, 0], np.int32)
    msg_off = np.array([0, 0, 0], np.int32)
    got = torch_embed.extract_block_message_device(
        torch.from_numpy(stego), bases, seg_len, msg_off, s, nbits, block,
        64).numpy()
    want = jax_embed.extract_block_message_device(
        jnp.asarray(stego), jnp.asarray(bases), jnp.asarray(seg_len),
        jnp.asarray(msg_off), jnp.int32(s), nbits, block, 64)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not got[:30].any() and got[30:50].any()


@pytest.mark.parametrize("h,w,block,dtype", [(64, 64, 8, np.uint16),
                                             (61, 67, 12, np.uint8)])
def test_block_embed_then_device_extract_round_trips(h, w, block, dtype):
    rng = np.random.default_rng(3)
    n = h * w
    img = _image(rng, h, w, dtype)
    s = 4
    nbits = _plane_bucket(s, 8 * np.dtype(dtype).itemsize)
    base, _ = _bases(img, nbits, s, block)
    total = segment_ops.usable_capacity_bits(s, n, 42)
    pp = segment_ops.raster_plane_plan(
        segment_ops.distribute_segments(s, total, 42), n, nbits, 0, True)
    msg = rng.integers(0, 2, total).astype(np.uint8)
    stego = torch_embed.embed_block_adaptive(
        torch.from_numpy(img), torch.from_numpy(msg), base, pp.lengths,
        pp.offsets, s, nbits, block)
    # the bases are the original's, as a decoder has them after restoring
    got = torch_embed.extract_block_message_device(
        stego, base, pp.lengths, pp.offsets, s, nbits, block, total)
    np.testing.assert_array_equal(got.numpy(), msg)
