"""The port's ``cli.train`` in EM mode against the JAX CLI on the bundled
fixtures (CPU): the same iteration count, per-iteration logliks within
1e-5 relative, the learned probabilities within 1e-4 absolute, the same
model meta, and models that decode to the same BED through both
packages' eval.  Covers random and flat init, semi-supervised priors
with fix and force masks, restarts, the device loop, checkpoints and
resuming a JAX-written checkpoint."""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu.cli import eval as jax_eval  # noqa: E402
from tehmm_tpu.cli import train as jax_train  # noqa: E402
from tehmm_tpu_torch.cli import eval as port_eval  # noqa: E402
from tehmm_tpu_torch.cli import train as port_train  # noqa: E402
from tehmm_tpu_torch.models.hmm import MultitrackHmm  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture
def workdir(tmp_path):
    """Copy fixtures (relative track paths in the XML resolve) and write
    the prior files."""
    for f in os.listdir(DATA):
        src = os.path.join(DATA, f)
        if os.path.isfile(src):
            shutil.copy(src, tmp_path / f)
    (tmp_path / "trans.txt").write_text(
        "BG BG 0.98\nBG TE 0.02\nTE TE 0.9\nTE BG 0.1\n")
    (tmp_path / "force_em.txt").write_text(
        "TE family none 0.3\nBG family none 0.6\n")
    (tmp_path / "init_em.txt").write_text(
        "TE family L1 0.7\nTE family SINE 0.1\n")
    return tmp_path


def _train(cli, workdir, name, flags, device=True):
    model = str(workdir / f"{name}.npz")
    log = workdir / f"{name}.jsonl"
    argv = [str(workdir / "tracks.xml"), str(workdir / "regions.bed"),
            model, "--logJson", str(log), *flags]
    if device:
        argv += ["--device", "cpu"]
    assert cli.main(argv) == 0
    return model, [json.loads(line) for line in open(log)]


def _eval(cli, workdir, model, name, device=True):
    out = str(workdir / name)
    argv = [str(workdir / "tracks.xml"), model,
            str(workdir / "regions.bed"), "--bed", out]
    if device:
        argv += ["--device", "cpu"]
    assert cli.main(argv) == 0
    return open(out).read()


def _both(workdir, flags):
    """Train with both CLIs; assert the runs agree; return the models."""
    flags = [str(f) for f in flags]
    ck.reset_launch_counts()
    j_model, j_log = _train(jax_train, workdir, "jax", flags, device=False)
    p_model, p_log = _train(port_train, workdir, "port", flags)
    assert all(n == 0 for n in ck.LAUNCHES.values())
    assert [r["iter"] for r in p_log] == [r["iter"] for r in j_log]
    key = "logliks" if "logliks" in j_log[0] else "loglik"
    np.testing.assert_allclose(
        np.asarray([r[key] for r in p_log], np.float64),
        np.asarray([r[key] for r in j_log], np.float64), rtol=1e-5,
    )
    jz, pz = np.load(j_model), np.load(p_model)
    for k in ("log_start", "log_trans", "log_em"):
        np.testing.assert_allclose(np.exp(pz[k]), np.exp(jz[k]), atol=1e-4,
                                   err_msg=k)
    assert bytes(pz["meta"]) == bytes(jz["meta"])
    return j_model, p_model


def _same_bed_everywhere(workdir, j_model, p_model):
    beds = {
        (m, e): _eval(cli, workdir, model, f"{m}_{e}.bed", e == "port")
        for m, model in (("jax", j_model), ("port", p_model))
        for e, cli in (("jax", jax_eval), ("port", port_eval))
    }
    first = beds[("jax", "jax")]
    assert all(bed == first for bed in beds.values()), list(beds)


def test_em_cli_matches_jax_and_decodes_alike(workdir):
    j_model, p_model = _both(
        workdir, ["--numStates", 2, "--iter", 30, "--seed", 3])
    _same_bed_everywhere(workdir, j_model, p_model)


def test_semi_supervised_cli_matches_jax(workdir):
    j_model, p_model = _both(
        workdir, ["--initTransProbs", workdir / "trans.txt", "--fixTrans",
                  "--iter", 8, "--seed", 5])
    model = MultitrackHmm.load(p_model, "cpu")
    assert model.state_names[:2] == ["BG", "TE"]
    np.testing.assert_allclose(np.exp(model.params.log_trans.numpy()),
                               [[0.98, 0.02], [0.1, 0.9]], atol=1e-5)
    _same_bed_everywhere(workdir, j_model, p_model)


@pytest.mark.parametrize("flags", [
    ["--forceEmProbs", "force_em.txt", "--initTransProbs", "trans.txt",
     "--iter", 10, "--seed", 5],
    ["--initEmProbs", "init_em.txt", "--fixEm", "--numStates", 3,
     "--iter", 6, "--seed", 1],
    ["--flatEm", "--initEmProbs", "init_em.txt", "--forceTransProbs",
     "trans.txt", "--iter", 4],
    ["--reps", 3, "--iter", 10, "--seed", 2],
    ["--deviceLoop", "--numStates", 3, "--iter", 12, "--seed", 4],
])
def test_em_cli_modes_match_jax(workdir, flags):
    flags = [workdir / f if str(f).endswith(".txt") else f for f in flags]
    _both(workdir, flags)


def _jax_checkpoint(workdir):
    ckpt = str(workdir / "jax_ckpt.npz")
    _train(jax_train, workdir, "first", [
        "--numStates", "3", "--iter", "4", "--seed", "3",
        "--checkpoint", ckpt, "--checkpointEvery", "2"], device=False)
    return ckpt


def test_jax_checkpoint_resumes_in_port(workdir):
    """A JAX-written --checkpoint resumes through the port's
    --initModel (with an emission prior on it), and the port's own
    checkpoint loads in the JAX package."""
    (workdir / "resume_em.txt").write_text("0 family L1 0.7\n")
    j_model, p_model = _both(workdir, [
        "--initModel", _jax_checkpoint(workdir), "--initEmProbs",
        workdir / "resume_em.txt", "--iter", 5,
        "--checkpoint", workdir / "resumed_ckpt.npz",
        "--checkpointEvery", 2])
    meta = json.loads(bytes(np.load(p_model)["meta"]).decode())
    assert meta["extra"]["iteration"] == 3
    from tehmm_tpu.models.hmm import MultitrackHmm as JaxHmm

    resumed = JaxHmm.load(str(workdir / "resumed_ckpt.npz"))
    assert resumed.num_states == 3


def test_resume_with_a_grown_alphabet_trains(workdir):
    """Resuming with an emission prior that adds two values to a track,
    so the widest alphabet grows from 5 to 6: the new column is padded
    with LOG_ZERO for the states the prior does not name, and EM trains
    with finite logliks.  (The JAX package's one-hot emission product
    turns the zero probabilities of that column into NaN here; the
    port's gather never reads them.  ROADMAP Queue 3.)"""
    (workdir / "grow_em.txt").write_text(
        "0 family L1 0.7\n0 family SINE 0.1\n0 family LTR 0.05\n")
    model, log = _train(port_train, workdir, "grown", [
        "--initModel", _jax_checkpoint(workdir), "--initEmProbs",
        str(workdir / "grow_em.txt"), "--iter", "5"])
    assert len(log) == 5
    assert np.isfinite([r["loglik"] for r in log]).all()
    lls = [r["loglik"] for r in log]
    assert all(b >= a - 1e-4 * abs(a) for a, b in zip(lls, lls[1:]))
    z = np.load(model)
    assert z["log_em"].shape[2] == 6
    assert np.isfinite(z["log_em"]).all()
