"""Write ``tests/data/torch_port_parity.json``: the JAX package's containers
for every case of ``tests/torch_port_cases.py``, as hashes.

Each case's ``EncodeConfig`` is the default with its strategy and its
overrides (``Case.config``). Per case it records the cut point ``s`` (0 for ``pee``), the payload size
and sha256 (of the uint8 0/1 bit array), the container's length and
sha256 and, for ``pee``, the PEE ext ``(T, passes, nproc0, nproc1, bits0,
bits1)``, so that a mismatch says which pass differed; all from
``codec_tcc_tpu.encode_array`` on the CPU. The torch port must reproduce
them byte for byte (``chip_smoke.py`` on the GPU,
``tests/test_torch_pipeline.py`` on the CPU).

Regenerate from the repository root with:

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixtures.py
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import torch_port_cases as cases  # noqa: E402


def jax_entry(case: cases.Case) -> dict:
    """Encode one case with the JAX package; return its JSON entry."""
    from codec_tcc_tpu import EncodeConfig, encode_array
    from codec_tcc_tpu.io.container import parse_pee_ext
    from codec_tcc_tpu.ops.decompose import decompose
    from codec_tcc_tpu.ops.segments import usable_capacity_bits

    img = cases.image(case)
    if case.strategy == "pee":
        s, capacity = 0, 0      # PEE has no cut point
    else:
        s = decompose(img, beta=0.4, nbits=case.bits_stored).s
        capacity = usable_capacity_bits(s, img.size, 42)
    bits = cases.payload_bits(case, capacity)
    res = encode_array(
        img, bits, case.config(EncodeConfig), bits_stored=case.bits_stored,
    )
    assert res.s == s
    entry = {
        "s": int(s),
        "payload_bits": int(bits.size),
        "payload_sha256": cases.sha256(bits),
        "container_len": len(res.container),
        "container_sha256": cases.sha256(res.container),
    }
    if case.strategy == "pee":
        entry["pee_ext"] = [int(v) for v in parse_pee_ext(res.meta.ext)]
    return entry


def main() -> int:
    out = {
        "generator": "tests/make_torch_port_fixtures.py",
        "reference": "codec_tcc_tpu.encode_array, EncodeConfig defaults "
                     "except strategy and each case's overrides, container "
                     "v2, deflate",
        "cases": {c.name: jax_entry(c) for c in cases.CASES},
    }
    if os.path.exists(cases.PARITY_JSON):
        # a new case must not move an entry already committed
        for name, entry in cases.load_parity().items():
            assert out["cases"].get(name) == entry, (
                f"{name}: the regenerated entry differs from the committed "
                f"one: {out['cases'].get(name)} != {entry}")
    with open(cases.PARITY_JSON, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(out["cases"], indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
