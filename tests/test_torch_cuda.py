"""The port's CUDA kernels on a GPU: K1/K2 against their plain versions and
the encode path against the CPU path. Marked ``cuda``: they skip where no
GPU is present and run on the GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

(this file imports no jax, so it runs where jax is not installed)."""

import numpy as np
import pytest
import torch

import codec_tcc_tpu_torch as port
from codec_tcc_tpu_torch.ops import raster_kernels as rk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the raster kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("h,w,dtype", [(64, 64, np.uint16), (37, 53, np.uint8),
                                       (512, 512, np.uint16)])
def test_kernels_match_plain_on_gpu(cuda, h, w, dtype):
    rng = np.random.default_rng(h * w)
    n = h * w
    hi = 1 << (8 * np.dtype(dtype).itemsize)
    img = torch.from_numpy(rng.integers(0, hi, (h, w)).astype(dtype)).to(cuda)
    msg = torch.from_numpy(rng.integers(0, 2, 3 * n).astype(np.uint8)).to(cuda)
    starts = rng.integers(0, n, 8)
    lens = rng.integers(0, n + 1, 8)
    offs = rng.integers(0, 2 * n, 8)
    emit = n % 8 == 0
    for s in (1, 3, 8):
        st_k, mp_k = rk.raster_embed(img, msg, starts, lens, offs, s,
                                     emit_maps=emit)
        st_p, mp_p = rk.raster_embed_plain(img, msg, starts, lens, offs, s,
                                           emit_maps=emit)
        torch.cuda.synchronize()
        assert torch.equal(st_k.cpu().to(torch.int32), st_p.cpu().to(torch.int32))
        if emit:
            assert torch.equal(mp_k.cpu(), mp_p.cpu())
        ex_k = rk.raster_extract(st_k, starts, lens, offs, s, 3 * n)
        ex_p = rk.raster_extract_plain(st_k, starts, lens, offs, s, 3 * n)
        torch.cuda.synchronize()
        assert torch.equal(ex_k.cpu(), ex_p.cpu())


def test_gpu_encode_equals_cpu_encode(cuda):
    rng = np.random.default_rng(1)
    img = np.clip(rng.normal(2000, 300, (96, 80)), 0, 4095).astype(np.uint16)
    rk.reset_launch_counts()
    res_g = port.encode_array(img, "gpu", bits_stored=12, device=cuda)
    res_c = port.encode_array(img, "gpu", bits_stored=12, device="cpu")
    assert res_g.container == res_c.container
    dec = port.decode_container(res_g.container, device=cuda)
    assert dec.message == "gpu"
    np.testing.assert_array_equal(dec.original, img)
    assert rk.LAUNCHES["raster_embed"] == 1
    assert rk.LAUNCHES["raster_extract"] == 1
