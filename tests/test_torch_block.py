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
from codec_tcc_tpu_torch import pipeline
from codec_tcc_tpu_torch.io import container as container_io
from codec_tcc_tpu_torch.io.codecs import get as get_codec
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


@pytest.mark.parametrize("h,w,block,dtype,s", GRID)
def test_block_bases_from_counts_equals_block_base_offsets(h, w, block, dtype,
                                                           s):
    """The loop-free base table equals ``block_base_offsets`` row for row
    (edge tiles, block 12 and a tile larger than the image among the
    geometries), and the table every block route ranks with
    (``block_bases``) is built from it."""
    rng = np.random.default_rng(11 * h * w + s)
    img = _image(rng, h, w, dtype)
    counts = torch_host_extract.block_counts_host(img, max(s, 1), block)
    for p in range(counts.shape[0]):
        got = block_ops.block_bases_from_counts(counts[p], h, w, block)
        want, _ = block_ops.block_base_offsets(counts[p], h, w, block)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=f"plane {p}")
    nbits = _plane_bucket(s, 8 * np.dtype(dtype).itemsize)
    got = block_ops.block_bases(torch.from_numpy(img), s, nbits, block)
    np.testing.assert_array_equal(got, _bases(img, nbits, s, block)[0])


# (h, w, block) whose exact keys take each of _int_keys' three forms: raw
# products too wide for the 16-bit sort (block 32), the lcm-scaled int64
# products (edge tiles at block 32), and Python ints (blocks of 100 with
# coprime edges: the squared lcm overflows int64)
KEY_FORMS = {"raw_int64": (96, 64, 32), "lcm_int64": (70, 45, 32),
             "python_ints": (197, 193, 100)}


@pytest.mark.parametrize("form", sorted(KEY_FORMS))
def test_block_bases_from_counts_on_each_key_form(form):
    h, w, block = KEY_FORMS[form]
    bh, bw = block_ops._tile_dims(h, w, block)
    k = bh * bw
    rng = np.random.default_rng(len(form))
    for counts in (rng.integers(0, k + 1), k // 2, k - k // 3):
        counts = np.broadcast_to(counts, k.shape).astype(np.int32)
        keys = block_ops._int_keys(counts, h, w, block)
        assert isinstance(keys, list) == (form == "python_ints")
        if form != "python_ints":
            assert int(np.max(keys)) >= 1 << 15
        got = block_ops.block_bases_from_counts(counts, h, w, block)
        want, _ = block_ops.block_base_offsets(counts, h, w, block)
        np.testing.assert_array_equal(got, want)


def _block_container(original, stego, s, payload_bits, block):
    """A v2 block_adaptive container of ``stego`` with the XOR maps back to
    ``original`` and the encoder's segment plan for ``payload_bits``
    (packed maps where ``H*W`` packs)."""
    h, w = stego.shape
    n = h * w
    nbits = _plane_bucket(s, 8 * stego.dtype.itemsize)
    if s:
        plan = segment_ops.distribute_segments(s, payload_bits, 42)
        pp = segment_ops.raster_plane_plan(plan, n, nbits, 0, True)
        sizes, indices = tuple(plan.sizes), tuple(plan.indices)
        lengths = tuple(int(v) for v in pp.lengths[:s])
    else:
        sizes = indices = lengths = ()
    maps = pipeline._host_xor_maps(original, stego, s).reshape(s, n)
    packed = n % 8 == 0
    maps_blob = (
        container_io.compress_bitmaps_packed(np.packbits(maps, axis=1))
        if packed else container_io.compress_bitmaps(maps))
    meta = container_io.ContainerMeta(
        version=2, codec="deflate", strategy="block_adaptive", s=s,
        nbits=8 * stego.dtype.itemsize, bits_stored=8 * stego.dtype.itemsize,
        dtype=stego.dtype, width=w, height=h, start_offset=0, seed=42,
        payload_bits=payload_bits, align_across_planes=True,
        has_bitmaps=True, bitmaps_packed=packed, sizes=sizes,
        indices=indices, eff_lengths=lengths, plane_starts=(0,) * s,
        ext=container_io.pack_block_ext(block))
    return container_io.pack(meta, maps_blob,
                             get_codec("deflate").encode(stego))


@pytest.mark.parametrize("h,w,block,dtype,s", GRID)
def test_decode_container_equals_extract_block_host(monkeypatch, h, w, block,
                                                    dtype, s):
    """``decode_container`` on the CPU reads a block container's payload
    through the base table and the device extract: the same bits as
    ``extract_block_host`` over ``ranking_from_counts`` of the restored
    original, at the three ``OUT_LEN`` lengths, and with a plane past ``s``
    given a nonzero length over an earlier plane's window."""
    rng = np.random.default_rng(13 * h * w + s)
    original = _image(rng, h, w, dtype)
    flips = rng.integers(0, 1 << s, (h, w)) if s else 0
    stego = (original ^ flips).astype(dtype)
    nbits = _plane_bucket(s, 8 * np.dtype(dtype).itemsize)
    real_plan = pipeline._plane_plan_from_meta
    for past_s in (False, True):
        def plan(meta, n, kernel_bits):
            starts, lengths, offsets = real_plan(meta, n, kernel_bits)
            if past_s and s < kernel_bits:
                lengths[s], offsets[s] = n, 3
            return starts, lengths, offsets

        monkeypatch.setattr(pipeline, "_plane_plan_from_meta", plan)
        for out_len in sorted(set(OUT_LEN.values())):
            blob = _block_container(original, stego, s, out_len, block)
            if s == 0 and (h * w) % 8:
                # raw maps of no plane do not parse (Container.diff, the
                # JAX package's code), on any route
                with pytest.raises(ValueError, match="reshape"):
                    pipeline.decode_container(blob, device="cpu")
                continue
            dec = pipeline.decode_container(blob, device="cpu")
            meta = container_io.parse(blob).meta
            _, lengths, offsets = plan(meta, h * w, nbits)
            if past_s and s < nbits:
                assert lengths[s] > 0
            counts = torch_host_extract.block_counts_host(original, s, block)
            rankings = [block_ops.ranking_from_counts(counts[p], h, w, block)
                        for p in range(s)]
            want = torch_host_extract.extract_block_host(
                stego, rankings, lengths, offsets, s, block, out_len)
            what = f"past_s={past_s} out_len={out_len}"
            np.testing.assert_array_equal(dec.payload_bits, want,
                                          err_msg=what)
            np.testing.assert_array_equal(dec.original, original,
                                          err_msg=what)


@pytest.mark.parametrize("route", ["batch", "tiled"])
def test_batch_and_tiled_decodes_count_as_single_decodes(route):
    """A batch decode of block containers, and a tiled decode of each,
    advance ``block.tiles_ranked`` and ``block.bits_placed`` by the sum of
    the single decodes of the same containers, and read the same bits."""
    from codec_tcc_tpu_torch import profiling
    from codec_tcc_tpu_torch.config import EncodeConfig
    from codec_tcc_tpu_torch.parallel import make_mesh, tile

    rng = np.random.default_rng(21)
    cfg = EncodeConfig(strategy="block_adaptive", compute_metrics=False)
    blobs = [
        pipeline.encode_array(
            rng.integers(0, peak, (40, 48)).astype(np.uint16),
            rng.integers(0, 2, bits).astype(np.uint8), cfg, bits_stored=12,
            device="cpu").container
        for peak, bits in ((4096, 300), (256, 1200), (4096, 0))
    ]
    keys = ("block.tiles_ranked", "block.bits_placed")

    def counted(decode):
        before = profiling.counters()
        decs = decode()
        after = profiling.counters()
        return decs, {k: after.get(k, 0) - before.get(k, 0) for k in keys}

    singles, want = counted(lambda: [
        pipeline.decode_container(b, device="cpu") for b in blobs])
    if route == "batch":
        decs, got = counted(lambda: torch_batch.decode_batch_containers(
            blobs, device="cpu"))
    else:
        mesh = make_mesh(devices=["cpu"] * 4, axes=("tile",))
        decs, got = counted(lambda: [
            tile.decode_container_tiled(b, mesh) for b in blobs])
    assert got == want and want["block.bits_placed"] == 1500
    for dec, single in zip(decs, singles):
        np.testing.assert_array_equal(dec.payload_bits, single.payload_bits)
        np.testing.assert_array_equal(dec.original, single.original)
