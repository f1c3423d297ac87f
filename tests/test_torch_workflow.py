"""The port's workflow tools against the JAX package's, on the CPU.

- ``view``: the text is the JAX tool's character for character, on a
  categorical, a gaussian and a pair-grammar model, under every flag;
  ``--plot`` writes its three PNGs through the port's ``analysis``.
- ``benchmark`` (train -> eval -> fit-state-names -> compare-bed-states,
  ``--device cpu``): ``sup``'s summary entry is the JAX run's key for key
  but the two ``_seconds``; ``em2``'s base accuracy is the JAX run's
  (``assert_em_accuracy``); ``--numProcesses 2`` keeps the summary's
  order and matches the sequential run.
- ``track-ranking``: the same tracks in the same order, with the same
  accuracies, as the JAX tool, in one process and in two workers."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu.cli import benchmark as jax_bench  # noqa: E402
from tehmm_tpu.cli import track_ranking as jax_rank  # noqa: E402
from tehmm_tpu.cli import train as jax_train  # noqa: E402
from tehmm_tpu.cli import view as jax_view  # noqa: E402
from tehmm_tpu.io import write_bed_intervals  # noqa: E402
from tehmm_tpu.models.hmm import MultitrackHmm as JaxHmm  # noqa: E402
from tehmm_tpu_torch.cli import benchmark as port_bench  # noqa: E402
from tehmm_tpu_torch.cli import track_ranking as port_rank  # noqa: E402
from tehmm_tpu_torch.cli import view as port_view  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


# ---------------------------------------------------------------------
# view
# ---------------------------------------------------------------------

def _gauss_inputs(tmp_path):
    """A categorical and a gaussian track (valCol 4) with a truth BED."""
    rng = np.random.RandomState(6)
    cat, gau, truth = [], [], []
    for s in range(0, 2000, 20):
        te = 500 <= s < 900 or 1400 <= s < 1600
        cat.append(("chr1", s, s + 20, "X" if te == (rng.rand() < 0.9)
                    else "Y"))
        gau.append(f"chr1\t{s}\t{s + 20}\tg\t"
                   f"{rng.normal(2.0 if te else -1.0):.4f}\n")
        truth.append(("chr1", s, s + 20, "TE" if te else "BG"))
    write_bed_intervals(cat, str(tmp_path / "cat.bed"))
    (tmp_path / "gau.bed").write_text("".join(gau))
    write_bed_intervals(truth, str(tmp_path / "truth.bed"))
    xml = tmp_path / "g.xml"
    xml.write_text(
        "<teModelConfig>"
        f'<track name="cat" path="{tmp_path / "cat.bed"}"/>'
        f'<track name="gau" path="{tmp_path / "gau.bed"}" '
        'distribution="gaussian" valCol="4"/>'
        "</teModelConfig>"
    )
    return str(xml), str(tmp_path / "truth.bed")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Model files written by the JAX train CLI: supervised on the
    repo's data, supervised with a gaussian track, and the first with
    a pair-grammar block in its metadata."""
    d = tmp_path_factory.mktemp("view_models")
    out = {"sup": str(d / "sup.npz"), "gauss": str(d / "gauss.npz"),
           "cfg": str(d / "cfg.npz")}
    assert jax_train.main([os.path.join(DATA, "tracks.xml"),
                           os.path.join(DATA, "truth.bed"), out["sup"],
                           "--supervised"]) == 0
    xml, truth = _gauss_inputs(d)
    assert jax_train.main([xml, truth, out["gauss"], "--supervised"]) == 0
    model = JaxHmm.load(out["sup"])
    S = model.num_states
    model.save(out["cfg"], extra={"cfg": {
        "pair_states": model.state_names[:2], "max_span": 64,
        "sa_prior": 0.5, "log_match": [-0.25 * (i + 1) for i in range(S)],
    }})
    return out


VIEW_FLAGS = {"all": [], "trans": ["--trans"], "em": ["--em"],
              "start": ["--start"], "precision": ["--precision", "2"],
              "em_start": ["--em", "--start"]}


@pytest.mark.parametrize("model", ["sup", "gauss", "cfg"])
@pytest.mark.parametrize("flags", sorted(VIEW_FLAGS))
def test_view_text(models, capsys, model, flags):
    argv = [models[model], *VIEW_FLAGS[flags]]
    assert jax_view.main(argv) == 0
    want = capsys.readouterr().out
    assert port_view.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.startswith("states (")
    if model == "cfg" and flags == "all":
        assert "cfg pair grammar:" in got


def test_view_plot(models, tmp_path, capsys):
    prefix = str(tmp_path / "m")
    assert port_view.main([models["sup"], "--plot", prefix,
                           "--device", "cpu"]) == 0
    assert f"wrote {prefix}.{{em,trans,pca}}.png" in capsys.readouterr().out
    for kind in ("em", "trans", "pca"):
        with open(f"{prefix}.{kind}.png", "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_view_missing_model(tmp_path):
    with pytest.raises(SystemExit, match="model file not found"):
        port_view.main([str(tmp_path / "none.npz"), "--device", "cpu"])


# ---------------------------------------------------------------------
# benchmark
# ---------------------------------------------------------------------

BENCH_L = 1200


def _bench_inputs(tmp_path):
    """tests/test_misc.py's benchmark input: one noisy track over a
    planted BG/TE/BG truth of 1200 bases."""
    rng = np.random.RandomState(0)
    L = BENCH_L
    truth = np.zeros(L, int)
    truth[300:600] = 1
    rows = [
        ("chr1", i, i + 20,
         "X" if (truth[i] and rng.rand() < 0.9) or
                (not truth[i] and rng.rand() < 0.1) else "Y")
        for i in range(0, L, 20)
    ]
    bed = str(tmp_path / "a.bed")
    write_bed_intervals(rows, bed)
    xml = tmp_path / "t.xml"
    xml.write_text(
        f'<teModelConfig><track name="a" path="{bed}"/>'
        "</teModelConfig>"
    )
    truth_rows = [("chr1", 0, 300, "BG"), ("chr1", 300, 600, "TE"),
                  ("chr1", 600, L, "BG")]
    tb = str(tmp_path / "truth.bed")
    write_bed_intervals(truth_rows, tb)
    rb = str(tmp_path / "r.bed")
    write_bed_intervals([("chr1", 0, L)], rb)
    return str(xml), tb, rb


BENCH_CONFIGS = ["--config", "sup:--supervised",
                 "--config", "em2:--numStates 2 --iter 10 --seed 1"]


def _summary(out):
    with open(os.path.join(out, "summary.json")) as fh:
        return {r["name"]: r for r in json.load(fh)}


def _no_seconds(entry):
    return {k: v for k, v in entry.items() if not k.endswith("_seconds")}


def assert_em_accuracy(got, want, L):
    """The port's EM accuracy: the JAX run's, or within one base of it
    where the two EMs round apart."""
    assert abs(got - want) <= 1.0 / L + 1e-12, (got, want)


@pytest.fixture(scope="module")
def bench_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    xml, tb, rb = _bench_inputs(d)
    runs = {}
    for tag, argv in (
        ("jax", None),
        ("port", ["--device", "cpu"]),
        ("port2", ["--device", "cpu", "--numProcesses", "2"]),
    ):
        out = str(d / tag)
        cli = jax_bench if argv is None else port_bench
        assert cli.main([xml, tb, rb, out, *BENCH_CONFIGS,
                         *(argv or [])]) == 0
        with open(os.path.join(out, "summary.json")) as fh:
            runs[tag] = [r["name"] for r in json.load(fh)]
        runs[tag + "_summary"] = _summary(out)
        runs[tag + "_dir"] = out
    return runs


def test_benchmark_supervised_entry_matches(bench_runs):
    want = bench_runs["jax_summary"]["sup"]
    got = bench_runs["port_summary"]["sup"]
    assert "error" not in got, got
    assert _no_seconds(got) == _no_seconds(want)
    assert set(got) == set(want)
    assert got["base_accuracy"] > 0.8
    for tag in ("jax", "port"):
        d = bench_runs[tag + "_dir"]
        assert os.path.exists(os.path.join(d, "sup.pred.bed"))
    with open(os.path.join(bench_runs["jax_dir"], "sup.pred.bed")) as a, \
            open(os.path.join(bench_runs["port_dir"], "sup.pred.bed")) as b:
        assert a.read() == b.read()


def test_benchmark_em_accuracy(bench_runs):
    want = bench_runs["jax_summary"]["em2"]
    got = bench_runs["port_summary"]["em2"]
    assert "error" not in got, got
    assert_em_accuracy(got["base_accuracy"], want["base_accuracy"],
                       BENCH_L)
    assert got["flags"] == want["flags"]
    assert os.path.exists(os.path.join(bench_runs["port_dir"],
                                       "em2.fit.bed"))


def test_benchmark_processes_keep_order(bench_runs):
    assert bench_runs["port2"] == ["sup", "em2"] == bench_runs["port"]
    par, seq = bench_runs["port2_summary"], bench_runs["port_summary"]
    assert all("error" not in r for r in par.values()), par
    for name in seq:
        assert _no_seconds(par[name]) == _no_seconds(seq[name])


def test_benchmark_failed_train_is_an_error_entry(tmp_path, capsys):
    xml, tb, rb = _bench_inputs(tmp_path)
    out = str(tmp_path / "out")
    assert port_bench.main([xml, tb, rb, out, "--device", "cpu",
                            "--config", "bad:--numStates 0"]) == 0
    entry = _summary(out)["bad"]
    assert set(entry) == {"name", "error"}
    assert "bad" in capsys.readouterr().out


def test_benchmark_duplicate_config(tmp_path):
    xml, tb, rb = _bench_inputs(tmp_path)
    with pytest.raises(SystemExit, match="duplicate"):
        port_bench.main([xml, tb, rb, str(tmp_path / "o"), "--device",
                         "cpu", "--config", "a:--supervised", "--config",
                         "a:--supervised"])


# ---------------------------------------------------------------------
# track-ranking
# ---------------------------------------------------------------------

def _ranking_inputs(tmp_path):
    """tests/test_tools.py's ranking input: an informative track, and a
    constant one."""
    L = 120
    truth = [("chr1", 0, 50, "BG"), ("chr1", 50, 80, "TE"),
             ("chr1", 80, 120, "BG")]
    good, noise = [], []
    for c, s, e, n in truth:
        for i in range(s, e, 10):
            good.append((c, i, min(i + 10, e), "X" if n == "TE" else "Y"))
            noise.append((c, i, min(i + 10, e), "Z"))
    gb, nb = str(tmp_path / "good.bed"), str(tmp_path / "noise.bed")
    write_bed_intervals(good, gb)
    write_bed_intervals(noise, nb)
    xml = tmp_path / "t.xml"
    xml.write_text(
        "<teModelConfig>"
        f'<track name="noise" path="{nb}"/>'
        f'<track name="good" path="{gb}"/>'
        "</teModelConfig>"
    )
    truth_bed = str(tmp_path / "truth.bed")
    write_bed_intervals(truth, truth_bed)
    regions = str(tmp_path / "r.bed")
    write_bed_intervals([("chr1", 0, L)], regions)
    return str(xml), truth_bed, regions


@pytest.mark.parametrize("procs", [1, 2])
def test_track_ranking_order(tmp_path, capsys, procs):
    xml, truth_bed, regions = _ranking_inputs(tmp_path)
    hist = {}
    for tag, cli, extra in (("jax", jax_rank, []),
                            ("port", port_rank,
                             ["--device", "cpu", "--numProcesses",
                              str(procs)])):
        out = str(tmp_path / tag)
        assert cli.main([xml, truth_bed, regions, out, *extra]) == 0
        with open(os.path.join(out, "ranking.json")) as fh:
            hist[tag] = json.load(fh)
        # the rank lines (workers print their eval scores elsewhere)
        hist[tag + "_out"] = [ln for ln in capsys.readouterr().out
                              .splitlines() if ln.startswith("rank ")]
    assert [h["track"] for h in hist["port"]] == ["good", "noise"]
    assert hist["port"] == hist["jax"]
    assert hist["port_out"] == hist["jax_out"] != []
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
