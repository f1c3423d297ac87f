"""The PyTorch port imports without JAX and without the JAX package.

The machine with the GPU has no JAX, and the port keeps its own copy of
every host module it needs, so ``tehmm_tpu_torch`` and every submodule
must import with ``jax`` and ``tehmm_tpu`` blocked, and no source file of
the port (nor ``chip_smoke.py``) may import either."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib
import pkgutil
import sys


BLOCKED = ("jax", "jaxlib", "tehmm_tpu")


class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None


sys.meta_path.insert(0, BlockJax())
import tehmm_tpu_torch

names = [m.name for m in pkgutil.walk_packages(
    tehmm_tpu_torch.__path__, "tehmm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print(" ".join(names))
"""

# every module of the slice
_MODULES = {
    "tehmm_tpu_torch." + m for m in (
        "utils.device", "utils.common", "native", "models.params",
        "models.emission", "models.gauss", "models.hmm", "ops.em", "ops.dp",
        "ops.cuda_kernels", "parallel.chunking", "parallel.stitch",
        "io", "io.bed", "io.category", "io.fasta", "io.trackxml",
        "io.trackdata", "io.bigwig", "io.priors", "io.segments",
        "cli.unported", "cli.train", "cli.eval", "cli.segment_tracks",
        "utils.profiling", "tools", "tools.bench_engines",
        "tools.profile_estep",
    )
}


def test_port_imports_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p
    )
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert _MODULES <= set(proc.stdout.split())


_SOURCES = sorted(
    str(p.relative_to(REPO))
    for p in pathlib.Path(REPO, "tehmm_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]


@pytest.mark.parametrize("rel", _SOURCES)
def test_source_never_imports_jax(rel):
    text = pathlib.Path(REPO, rel).read_text()
    assert not re.search(
        r"^\s*(import|from)\s+(jax|jaxlib)\b", text, re.M,
    ), f"{rel} imports JAX"
    assert not re.search(
        r"^\s*(import|from)\s+tehmm_tpu(\.|\s|$)", text, re.M,
    ), f"{rel} imports the JAX package tehmm_tpu"
