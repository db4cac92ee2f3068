"""The port's ops against the JAX package's on the same seeded inputs:
value histogram, cut point, block popcounts and ranking, segment plans
(all exact) and the metric moments (float32 sums, tolerances below)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codec_tcc_tpu.ops import blocks as jax_blocks
from codec_tcc_tpu.ops import decompose as jax_decompose
from codec_tcc_tpu.ops import embed as jax_embed
from codec_tcc_tpu.ops import histogram as jax_hist
from codec_tcc_tpu.ops import metrics as jax_metrics
from codec_tcc_tpu.ops import segments as jax_segments
from codec_tcc_tpu_torch.ops import blocks as torch_blocks
from codec_tcc_tpu_torch.ops import decompose as torch_decompose
from codec_tcc_tpu_torch.ops import embed as torch_embed
from codec_tcc_tpu_torch.ops import histogram as torch_hist
from codec_tcc_tpu_torch.ops import metrics as torch_metrics
from codec_tcc_tpu_torch.ops import segments as torch_segments

import torch_port_cases as cases
from torch_parity import same_code

torch.set_num_threads(1)

SHAPES = [(64, 64, np.uint16), (37, 53, np.uint16), (64, 64, np.uint8),
          (37, 53, np.uint8)]


def _image(seed, h, w, dtype, bits=12):
    """A smooth gradient plus noise: a realistic value histogram, unlike
    uniform noise, so the cut point lands mid-range."""
    rng = np.random.default_rng(seed)
    hi = 255 if dtype == np.uint8 else (1 << bits) - 1
    y, x = np.mgrid[0:h, 0:w]
    base = (x + y) / (h + w) * hi * 0.7
    return np.clip(base + rng.normal(0, hi * 0.03, (h, w)), 0, hi).astype(dtype)


@pytest.mark.parametrize("h,w,dtype", SHAPES)
def test_value_histogram_matches_jax(h, w, dtype):
    img = _image(1, h, w, dtype)
    nbins = 256 if dtype == np.uint8 else 65536
    got = torch_hist.value_histogram(torch.from_numpy(img), nbins).numpy()
    want = np.asarray(jax_hist.value_histogram(jnp.asarray(img), nbins))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_hist.host_histogram(img, nbins))


@pytest.mark.parametrize("h,w,dtype", SHAPES)
@pytest.mark.parametrize("beta", [0.4, 0.8])
def test_decompose_matches_jax(h, w, dtype, beta):
    img = _image(2, h, w, dtype)
    nbits = 8 if dtype == np.uint8 else 12
    got = torch_decompose.decompose(torch.from_numpy(img), beta, nbits)
    want = jax_decompose.decompose(img, beta, nbits)
    assert (got.s, got.nbits, got.entropy, got.target) == (
        want.s, want.nbits, want.entropy, want.target)
    np.testing.assert_array_equal(got.mi, want.mi)
    np.testing.assert_array_equal(got.cumulative, want.cumulative)


@pytest.mark.parametrize("h,w,dtype", SHAPES)
@pytest.mark.parametrize("block", [8, 16])
def test_block_counts_and_ranking_match_jax(h, w, dtype, block):
    img = _image(3, h, w, dtype)
    got = torch_blocks.block_bit_counts_all(torch.from_numpy(img), 4, block)
    want = np.asarray(jax_blocks.block_bit_counts_all(jnp.asarray(img), 4, block))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got0 = torch_blocks.block_bit_counts(torch.from_numpy(img), 0, block)
    np.testing.assert_array_equal(got0.numpy(), want[0])
    for p in range(4):
        assert torch_blocks.best_offset_from_counts(want[p], h, w, block) == (
            jax_blocks.best_offset_from_counts(want[p], h, w, block))
        assert torch_blocks.ranking_from_counts(want[p], h, w, block) == (
            jax_blocks.ranking_from_counts(want[p], h, w, block))
        gb, gr = torch_blocks.block_base_offsets(want[p], h, w, block)
        wb, wr = jax_blocks.block_base_offsets(want[p], h, w, block)
        np.testing.assert_array_equal(gb, wb)
        assert gr == wr


@pytest.mark.parametrize("s", [1, 2, 3, 5, 8])
def test_segment_plans_match_jax(s):
    rng = np.random.default_rng(s)
    n = 37 * 53
    for total in [0, 1, 7, 304, int(rng.integers(0, s * n))]:
        a = torch_segments.distribute_segments(s, total, 42)
        b = jax_segments.distribute_segments(s, total, 42)
        assert vars(a) == vars(b)
        start = int(rng.integers(0, n))
        for align in (False, True):
            pa = torch_segments.raster_plane_plan(a, n, 8, start, align)
            pb = jax_segments.raster_plane_plan(b, n, 8, start, align)
            for f in ("starts", "lengths", "offsets"):
                np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))
            assert pa.base_start_offset == pb.base_start_offset
    assert torch_segments.usable_capacity_bits(s, n, 42) == (
        jax_segments.usable_capacity_bits(s, n, 42))


def test_copied_host_code_is_unchanged():
    """The host halves of the ported ops are copies: same code as the JAX
    originals (docstrings and imports aside)."""
    assert same_code(torch_segments, jax_segments)
    for name in ("entropy_from_counts", "mutual_information_from_counts",
                 "_h_y", "_mi_plane", "_mi_plane_nz", "plane_mi_curve"):
        assert same_code(getattr(torch_hist, name), getattr(jax_hist, name)), name
    for name in ("_tile_dims", "_int_keys", "ranking_from_counts",
                 "best_offset_from_counts", "block_base_offsets"):
        assert same_code(getattr(torch_blocks, name), getattr(jax_blocks, name)), name
    for name in ("psnr_from_mse", "quality_report"):
        assert same_code(getattr(torch_metrics, name), getattr(jax_metrics, name)), name
    for name in ("assemble_message", "pad_message"):
        assert same_code(getattr(torch_embed, name), getattr(jax_embed, name)), name


# float32 moments summed over up to 2^18 pixels in another order than XLA's:
# measured relative differences up to 6e-6 on the parity cases, so 2e-5.
# Global SSIM subtracts those moments (var = E[a^2] - mu^2) and measured up
# to 7e-6 apart, so an absolute 5e-5. Integer-valued sums below 2^24 are
# exact in any order; mse/mean_abs_diff can pass 2^24 for many changed
# pixels, hence 1e-6.
MOMENT_RTOL = 2e-5
SSIM_ATOL = 5e-5


@pytest.mark.parametrize("name", ["mr512_u16", "ot512_u8", "odd500x501_u8"])
def test_pair_stats_and_quality_report_match_jax(name):
    img = cases.image(cases.BY_NAME[name])
    rng = np.random.default_rng(4)
    flips = (rng.random(img.shape) < 0.3) * rng.integers(0, 32, img.shape)
    stego = img ^ flips.astype(img.dtype)
    got = torch_metrics.pair_stats(torch.from_numpy(img), torch.from_numpy(stego))
    want = jax_metrics.pair_stats(jnp.asarray(img), jnp.asarray(stego))
    for k in ("n", "changed", "max_absdiff", "max_a", "max_b"):
        assert float(got[k]) == float(want[k]), k
    for k in ("sum_a", "sum_b", "sum_a2", "sum_b2", "sum_ab", "sum_sqdiff",
              "sum_absdiff"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=MOMENT_RTOL, err_msg=k)
    rg = torch_metrics.quality_report(got)
    rw = jax_metrics.quality_report(want)
    assert rg["changed_pixels"] == rw["changed_pixels"]
    assert rg["max_abs_diff"] == rw["max_abs_diff"]
    assert rg["max_value"] == rw["max_value"]
    for k in ("mse", "psnr", "mean_abs_diff", "changed_percent"):
        np.testing.assert_allclose(rg[k], rw[k], rtol=1e-6, err_msg=k)
    assert abs(rg["ssim"] - rw["ssim"]) <= SSIM_ATOL


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_restore_original_and_xor_maps_match_jax(dtype):
    rng = np.random.default_rng(6)
    img = _image(6, 32, 64, dtype)
    stego = img ^ rng.integers(0, 8, img.shape).astype(dtype)
    tmaps = torch_embed.xor_maps_packed_batch(
        torch.from_numpy(img)[None], torch.from_numpy(stego)[None], 3)
    jmaps = jax_embed.xor_maps_packed_batch(
        jnp.asarray(img)[None], jnp.asarray(stego)[None], 3)
    np.testing.assert_array_equal(tmaps.numpy(), np.asarray(jmaps))
    raw = np.stack([((img ^ stego) >> k) & 1 for k in range(4)]).astype(np.uint8)
    got = torch_embed.restore_original(
        torch.from_numpy(stego), torch.from_numpy(raw), 3)
    want = jax_embed.restore_original(jnp.asarray(stego), jnp.asarray(raw), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
