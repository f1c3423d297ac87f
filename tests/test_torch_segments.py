"""Segment mode in the port against the JAX CLIs, on the CPU.

The workflow of SURVEY §3.4: ``segment_tracks`` collapses a region's
constant track columns into segments, ``train --segment [--segLen]``
runs EM with one observation per segment (each emission raised to the
power of the segment's length under ``--segLen``), and ``eval --segment``
decodes at segment resolution and expands the path back to bases.

- ``segment_tracks``: the port's BED is the JAX tool's byte for byte.
- ``train --segment``: the same iteration count and logliks within 1e-5
  relative (both packages sum the same float32 terms in another order).
- ``eval --segment`` on a JAX-written model: Viterbi (stitched and
  ``--exact``) and ``--maxPost`` (stitched and ``--exact``) BED byte for
  byte, the printed score within 1e-5 relative, ``--pd`` rows within
  1e-5 (``%.6g``-printed probabilities); scoring with no ``--bed``.

The fixture has a categorical track and a gaussian track whose values are
constant over runs, so segments compress the region ~40x and still carry
both streams.  Short ``--chunk``/``--halo`` make the segment chains span
several chunks."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu.cli import eval as jax_eval  # noqa: E402
from tehmm_tpu.cli import segment_tracks as jax_seg  # noqa: E402
from tehmm_tpu.cli import train as jax_train  # noqa: E402
from tehmm_tpu.io import write_bed_intervals  # noqa: E402
from tehmm_tpu_torch.cli import eval as port_eval  # noqa: E402
from tehmm_tpu_torch.cli import segment_tracks as port_seg  # noqa: E402
from tehmm_tpu_torch.cli import train as port_train  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402


@pytest.fixture(params=["categorical", "with_gauss"])
def seg_dir(tmp_path, request):
    """Two chromosome regions of blocky tracks: a 2-symbol categorical
    track and, with ``with_gauss``, a gaussian score track (valCol 4)
    constant over runs, with gaps."""
    rng = np.random.RandomState(5)
    L = 4000
    cat, gau = [], []
    for chrom in ("chr1", "chr2"):
        truth = np.zeros(L, int)
        for s in range(300, L - 300, 800):
            truth[s : s + 250] = 1
        pos = 0
        while pos < L:
            end = min(pos + rng.randint(30, 80), L)
            cat.append((chrom, pos, end, "X" if truth[pos] else "Y"))
            if rng.rand() < 0.85:
                v = rng.normal(3.0 if truth[pos] else 0.0, 1.0)
                gau.append((chrom, pos, end, "g", f"{v:.4f}"))
            pos = end
    write_bed_intervals(cat, str(tmp_path / "a.bed"))
    tracks = f'<track name="a" path="{tmp_path / "a.bed"}"/>'
    if request.param == "with_gauss":
        (tmp_path / "g.bed").write_text(
            "".join("\t".join(map(str, r)) + "\n" for r in gau))
        tracks += (f'<track name="g" path="{tmp_path / "g.bed"}" '
                   'distribution="gaussian" valCol="4"/>')
    xml = tmp_path / "t.xml"
    xml.write_text(f"<teModelConfig>{tracks}</teModelConfig>")
    regions = str(tmp_path / "r.bed")
    write_bed_intervals([("chr1", 0, L), ("chr2", 200, L)], regions)
    return dict(dir=tmp_path, xml=str(xml), regions=regions, L=L)


def _segments(f, flags=()):
    out = []
    for name, cli in (("j", jax_seg), ("p", port_seg)):
        path = str(f["dir"] / f"segs_{name}.bed")
        assert cli.main([f["xml"], f["regions"], path, *flags]) == 0
        out.append(open(path).read())
    return out


@pytest.mark.parametrize("flags", [[], ["--maxLen", "50"],
                                   ["--thresh", "1"]])
def test_segment_tracks_output_matches_jax(seg_dir, flags):
    want, got = _segments(seg_dir, flags)
    assert got == want
    n_segs = len(want.splitlines())
    assert 0 < n_segs < seg_dir["L"] // 10


def _train(cli, f, segs, name, flags, device=True):
    model = str(f["dir"] / f"{name}.npz")
    log = f["dir"] / f"{name}.jsonl"
    argv = [f["xml"], segs, model, "--logJson", str(log), *flags]
    if device:
        argv += ["--device", "cpu"]
    assert cli.main(argv) == 0
    return model, [json.loads(line)["loglik"] for line in open(log)]


@pytest.mark.parametrize("seg_len", [False, True])
def test_train_segment_matches_jax(seg_dir, seg_len):
    f = seg_dir
    _segments(f)
    segs = str(f["dir"] / "segs_p.bed")
    flags = ["--segment", "--numStates", "2", "--iter", "25", "--seed",
             "4", "--chunk", "64"] + (["--segLen"] if seg_len else [])
    ck.reset_launch_counts()
    _jm, jll = _train(jax_train, f, segs, "j", flags, device=False)
    _pm, pll = _train(port_train, f, segs, "p", flags)
    assert not any(ck.LAUNCHES.values())
    assert len(pll) == len(jll) > 1
    np.testing.assert_allclose(pll, jll, rtol=1e-5)
    assert np.all(np.diff(pll) >= -1e-4 * np.abs(pll[1:]))


def test_train_segment_supervised_is_rejected(seg_dir):
    f = seg_dir
    with pytest.raises(SystemExit, match="segment"):
        port_train.main([f["xml"], f["regions"], str(f["dir"] / "x.npz"),
                         "--segment", "--supervised", "--device", "cpu"])


@pytest.fixture
def jax_model(seg_dir):
    """Segments and a --segment --segLen model, both from the JAX
    tools."""
    f = seg_dir
    _segments(f)
    segs = str(f["dir"] / "segs_j.bed")
    model, _ = _train(jax_train, f, segs, "jm",
                      ["--segment", "--segLen", "--numStates", "3",
                       "--iter", "10", "--seed", "2"], device=False)
    return f, segs, model


def _eval(cli, f, model, segs, flags, capsys, device=True):
    argv = [f["xml"], model, segs, "--segment", *flags]
    if device:
        argv += ["--device", "cpu"]
    capsys.readouterr()
    assert cli.main(argv) == 0
    return float(capsys.readouterr().out.strip())


EVAL_MODES = {
    "viterbi_stitched": ["--no-exact"],
    "viterbi_exact": ["--exact"],
    "maxpost_stitched": ["--maxPost", "--no-exact"],
    "maxpost_exact": ["--maxPost", "--exact"],
}


@pytest.mark.parametrize("seg_len", [True, False])
@pytest.mark.parametrize("mode", sorted(EVAL_MODES))
def test_eval_segment_matches_jax(jax_model, capsys, mode, seg_len):
    f, segs, model = jax_model
    flags = EVAL_MODES[mode] + ["--chunk", "32", "--halo", "8"] + (
        ["--segLen"] if seg_len else [])
    beds, scores = [], []
    for name, cli, device in (("j", jax_eval, False), ("p", port_eval, True)):
        out = str(f["dir"] / f"{mode}_{name}.bed")
        scores.append(_eval(cli, f, model, segs, flags + ["--bed", out],
                            capsys, device))
        beds.append(open(out).read())
    assert beds[1] == beds[0]
    np.testing.assert_allclose(scores[1], scores[0], rtol=1e-5)
    covered = sum(int(r.split("\t")[2]) - int(r.split("\t")[1])
                  for r in beds[1].splitlines())
    assert covered == f["L"] + f["L"] - 200


def test_eval_segment_pd_and_score_match_jax(jax_model, capsys):
    f, segs, model = jax_model
    rows, scores = [], []
    for name, cli, device in (("j", jax_eval, False), ("p", port_eval, True)):
        pd = str(f["dir"] / f"pd_{name}.bed")
        scores.append(_eval(cli, f, model, segs,
                            ["--segLen", "--chunk", "32", "--pd", pd],
                            capsys, device))
        rows.append([line.split("\t") for line in open(pd)])
        # scoring alone (no --bed, no --pd): the forward log-likelihood
        scores.append(_eval(cli, f, model, segs, ["--segLen"], capsys,
                            device))
    np.testing.assert_allclose(scores[2:], scores[:2], rtol=1e-5)
    assert len(rows[1]) == len(rows[0]) == len(open(segs).readlines())
    for a, b in zip(rows[1], rows[0]):
        assert a[:3] == b[:3]
        np.testing.assert_allclose(np.array(a[3].split(","), float),
                                   np.array(b[3].split(","), float),
                                   atol=1e-5)
