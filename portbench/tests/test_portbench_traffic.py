"""The traffic generator: the same seed gives the same pool, another seed
other noise and payloads at the same sizes."""

import numpy as np

from portbench import harness
from portbench.traffic import generator

from .small import SMALL


def _pool(cell, seed):
    wl, cfg = harness.load_cell(cell)
    for k, v in SMALL[cell].items():
        (wl if k in wl else cfg)[k] = v
    return generator.make_pool(cfg, wl, seed)


def _arrays(pool):
    out = []
    for unit in pool:
        out.append(unit.get("volume", unit.get("images")))
        out.extend(unit["payloads"])
    return out


def test_deterministic_per_seed():
    for cell in SMALL:
        a = _arrays(_pool(cell, 2**31 + 7))
        b = _arrays(_pool(cell, 2**31 + 7))
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_other_seed_same_sizes_other_data():
    for cell in SMALL:
        a = _arrays(_pool(cell, 3))
        b = _arrays(_pool(cell, 4))
        assert [x.shape for x in a] == [y.shape for y in b]
        assert any(not np.array_equal(x, y) for x, y in zip(a, b))


def test_phantom_matches_the_test_cases_copy():
    """The copy keeps the phantom of tests/torch_port_cases.py: the same
    smooth part, noise of 2% of full scale, BitsStored respected."""
    img = generator.images(512, 512, "uint16", 12, 1, 11)[0]
    assert img.dtype == np.uint16 and int(img.max()) <= 4095
    assert 0.3 < img.mean() / 4095 < 0.6
