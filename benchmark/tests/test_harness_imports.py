"""No JAX in a run: the forbidden names are compared by whole top-level
name, nothing the harness imports loads JAX or the JAX package, and the
reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

import pytest

from benchmark import imports
from benchmark.tests import tiny


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("vae_hmc_tpu", True), ("vae_hmc_tpu.ops", True),
    ("vae_hmc_tpu_torch", False), ("vae_hmc_tpu_torch.ops.stft", False),
    ("jaxtyping", False), ("flaxen", False), ("torch", False),
])
def test_whole_top_level_name(name, bad):
    assert (imports.forbidden_in([name]) == [name]) is bad


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    for path in sorted((tiny.ROOT / "benchmark" / "reference").glob("*.py")):
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in imports.FORBIDDEN, (path.name, mod)
            assert top not in ("vae_hmc_tpu_torch", "benchmark") or \
                mod.startswith("benchmark.reference"), (path.name, mod)


def test_no_source_of_the_benchmark_imports_jax():
    for path in sorted((tiny.ROOT / "benchmark").rglob("*.py")):
        for mod in _imported_modules(path):
            assert imports.top_level(mod) not in imports.FORBIDDEN, \
                (path, mod)


SCRIPT = r"""
import sys, time, torch
from benchmark import harness, imports
from benchmark.tests import tiny
import benchmark.control, benchmark.run  # noqa: F401
res = harness.run_cell(tiny.conv_cell(), 3, 0.2, False, torch.device("cpu"),
                       time.perf_counter())
print(sorted(m for m in sys.modules if imports.top_level(m) in
             ("jax", "jaxlib", "flax", "vae_hmc_tpu")))
"""


def test_a_run_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(tiny.ROOT))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tiny.ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
