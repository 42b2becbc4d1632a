"""What the benchmark may import: never JAX or the JAX package (compared by
whole top-level names, since the port's name begins with the JAX
package's), and in the reference nothing of the port either."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from wmhbench import harness

REFERENCE_REFUSES = harness.FORBIDDEN_MODULES + ("deepwmh_tpu_torch",)


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = "") -> list:
    out = []
    for root, _dirs, files in os.walk(os.path.join(harness.PKG_DIR, sub)):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("modules,found", [
    ({"deepwmh_tpu_torch", "deepwmh_tpu_torch.unet.model", "numpy"}, []),
    ({"deepwmh_tpu.unet.model", "deepwmh_tpu_torch"}, ["deepwmh_tpu"]),
    ({"jax.numpy", "jaxlib", "flax.linen", "optax", "jaxtyping"}, ["flax", "jax", "jaxlib",
                                                                    "optax"]),
])
def test_forbidden_names_compare_whole(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & set(harness.FORBIDDEN_MODULES), path


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert not _imports(path) & set(REFERENCE_REFUSES), path


def test_harness_and_drivers_load_no_forbidden_module():
    code = ("import importlib, wmhbench.run, wmhbench.readings\n"
            "from wmhbench import harness\n"
            "for d in ('train', 'predict', 'stage1'):\n"
            "    harness.driver_module(d)\n"
            "for m in ('unet.train', 'pipeline.inference', 'pipeline.analysis'):\n"
            "    importlib.import_module('deepwmh_tpu_torch.' + m)\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_exits_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "wmhbench.run", "--workload",
                          harness.benchmark_spec()["workloads"][0]["name"], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
