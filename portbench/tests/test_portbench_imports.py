"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: ``codec_tcc_tpu_torch`` is the port), and the plain
reference loads neither those nor the port."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "codec_tcc_tpu"}


def _top_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_neither_jax_nor_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert not _top_imports(path) & (BANNED | {"codec_tcc_tpu_torch"}), path


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "import portbench.reference.judge, portbench.reference.pee, "
        "portbench.reference.control, portbench.work")
    assert not loaded & (BANNED | {"codec_tcc_tpu_torch"})


def test_dry_run_loads_no_jax():
    loaded = _loaded_after(
        "import time\nfrom portbench import harness\n"
        "from portbench.tests.small import SMALL\n"
        "for cell in sorted(SMALL):\n"
        "    for traced in (False, True):\n"
        "        harness.run_cell(cell, 7, 0.2, traced, device='cpu', "
        "t0=time.perf_counter(), overrides=SMALL[cell])\n")
    assert "codec_tcc_tpu_torch" in loaded
    assert not loaded & BANNED


def test_run_refuses_a_machine_without_a_card():
    import torch

    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mr512_hybrid.single", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
