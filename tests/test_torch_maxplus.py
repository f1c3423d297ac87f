"""K9, the max-plus sweep experiment, on the CPU: the port's plain sweep
(``cuda_kernels.maxplus_sweeps_plain``, which ``maxplus_sweeps`` takes
for a CPU tensor) against the JAX tool's ``_ref_sweep`` and both of its
Pallas formulations in interpret mode (``_kernel_unrolled``, and
``_kernel_scratch_blocks`` at blk 8, 16 and 32), all from
``tools/exp_maxplus_s256.py``, on the tool's own draw; and the port's
tool with ``--device cpu``.

Every operation of a sweep is an exact max or one correctly rounded add
or subtract, so every comparison is bit for bit.  Sp=256, Bg=128 (the
tool's shape) for the unrolled kernel and one blocks case; smaller Sp
for the rest, to keep the file to seconds."""

import functools
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.tools import exp_maxplus_s256 as ttool  # noqa: E402


_SPEC = importlib.util.spec_from_file_location(
    "jax_exp_maxplus_s256",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tools", "exp_maxplus_s256.py"))
jtool = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jtool)


def _inputs(Sp, Bg, seed=0):
    """The JAX tool's draw: v, then T, standard normal."""
    rng = np.random.RandomState(seed)
    v = rng.randn(Sp, Bg).astype(np.float32)
    t = rng.randn(Sp, Sp).astype(np.float32)
    return v, t


def _plain(v, t):
    return ck.maxplus_sweeps_plain(torch.from_numpy(v),
                                   torch.from_numpy(t)).numpy()


def _unrolled(v, t):
    shape = jax.ShapeDtypeStruct(v.shape, jnp.float32)
    return np.asarray(pl.pallas_call(jtool._kernel_unrolled,
                                     out_shape=shape, interpret=True)(
        jnp.asarray(v), jnp.asarray(t)))


def _blocks(v, t, blk):
    Sp, Bg = v.shape
    call = pl.pallas_call(
        functools.partial(jtool._kernel_scratch_blocks, blk),
        out_shape=jax.ShapeDtypeStruct((Sp, Bg), jnp.float32),
        scratch_shapes=[pltpu.VMEM((blk, Sp, Bg), jnp.float32),
                        pltpu.VMEM((Sp, Bg), jnp.float32)],
        interpret=True)
    return np.asarray(call(jnp.asarray(v), jnp.asarray(t)))


def test_inputs_are_the_tools_draw():
    v, t = ttool.make_inputs(8, 5, torch.device("cpu"))
    want_v, want_t = _inputs(8, 5)
    np.testing.assert_array_equal(v.numpy(), want_v)
    np.testing.assert_array_equal(t.numpy(), want_t)


@pytest.mark.parametrize("Sp,Bg", [(256, 128), (40, 12)])
def test_plain_sweep_equals_ref_sweep(Sp, Bg):
    v, t = _inputs(Sp, Bg)
    want = np.asarray(jax.jit(jtool._ref_sweep)(jnp.asarray(v),
                                                jnp.asarray(t)))
    np.testing.assert_array_equal(_plain(v, t), want)


def test_plain_sweep_equals_the_unrolled_kernel():
    v, t = _inputs(256, 128)
    np.testing.assert_array_equal(_plain(v, t), _unrolled(v, t))


@pytest.mark.parametrize("Sp,Bg,blk", [(256, 128, 32), (64, 16, 8),
                                       (64, 16, 16), (64, 16, 32)])
def test_plain_sweep_equals_the_scratch_blocks_kernel(Sp, Bg, blk):
    v, t = _inputs(Sp, Bg)
    np.testing.assert_array_equal(_plain(v, t), _blocks(v, t, blk))


@pytest.mark.parametrize("layout,blk", [("resident", None), ("blocks", 8),
                                        ("blocks", 32)])
def test_wrapper_takes_the_plain_sweep_on_the_cpu(layout, blk):
    """On a CPU tensor the wrapper is the plain version and launches
    nothing; its argument checks hold."""
    v, t = (torch.from_numpy(x) for x in _inputs(24, 6))
    before = dict(ck.LAUNCHES)
    got = ck.maxplus_sweeps(v, t, layout, blk)
    assert torch.equal(got, ck.maxplus_sweeps_plain(v, t))
    assert ck.LAUNCHES == before


def test_wrapper_checks_its_arguments():
    v, t = (torch.from_numpy(x) for x in _inputs(24, 6))
    with pytest.raises(ValueError, match="layout"):
        ck.maxplus_sweeps(v, t, "unrolled")
    with pytest.raises(ValueError, match="blk"):
        ck.maxplus_sweeps(v, t, "blocks", 12)
    with pytest.raises(ValueError, match="blk"):
        ck.maxplus_sweeps(v, t, "resident", 8)
    with pytest.raises(ValueError, match="T"):
        ck.maxplus_sweeps(v, t[:5], "resident")
    with pytest.raises(TypeError, match="v"):
        ck.maxplus_sweeps(v.double(), t, "resident")


def test_tool_on_the_cpu_prints_its_rows(capsys):
    """``python -m tehmm_tpu_torch.tools.exp_maxplus_s256 --device cpu``:
    the device line, the shape line, then one row per formulation in the
    JAX tool's order, each ok with max|delta| 0."""
    assert ttool.main(["--device", "cpu", "--sp", "32", "--bg", "8",
                       "--reps", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# device: cpu"
    rows = [line for line in lines if not line.startswith("#")]
    assert [r.split("  ")[0].strip() for r in rows] == \
        [name for name, _l, _b in ttool.FORMULATIONS]
    assert all(" ok " in r and r.endswith("max|delta| 0.00e+00")
               for r in rows)
