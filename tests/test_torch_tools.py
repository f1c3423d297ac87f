"""The port's host tools against the JAX package's, on the CPU.

compare-bed-states, fit-state-names, bed-tools, clean-external,
set-track-scaling, track-dump and the parameter analysis run no device
code: each port tool is the JAX tool's logic over the port's own ``io``.
Each case runs both tools on the same inputs and holds the port's files
and stdout to the JAX tool's byte for byte.  The dispatcher
(``python -m tehmm_tpu_torch``) and ``entrypoints`` keep the JAX
package's tool names and exit codes."""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tehmm_tpu.__main__ as jax_main  # noqa: E402
import tehmm_tpu.entrypoints as jax_entry  # noqa: E402
from tehmm_tpu import analysis as jax_analysis  # noqa: E402
from tehmm_tpu.cli import bed_tools as jax_bed  # noqa: E402
from tehmm_tpu.cli import clean_external as jax_clean  # noqa: E402
from tehmm_tpu.cli import compare_bed_states as jax_cbs  # noqa: E402
from tehmm_tpu.cli import fit_state_names as jax_fsn  # noqa: E402
from tehmm_tpu.cli import set_track_scaling as jax_sts  # noqa: E402
from tehmm_tpu.cli import track_dump as jax_dump  # noqa: E402
from tehmm_tpu.io import write_bed_intervals  # noqa: E402
import tehmm_tpu_torch.__main__ as port_main  # noqa: E402
import tehmm_tpu_torch.entrypoints as port_entry  # noqa: E402
from tehmm_tpu_torch import analysis as port_analysis  # noqa: E402
from tehmm_tpu_torch.cli import bed_tools as port_bed  # noqa: E402
from tehmm_tpu_torch.cli import clean_external as port_clean  # noqa: E402
from tehmm_tpu_torch.cli import compare_bed_states as port_cbs  # noqa: E402
from tehmm_tpu_torch.cli import fit_state_names as port_fsn  # noqa: E402
from tehmm_tpu_torch.cli import set_track_scaling as port_sts  # noqa: E402
from tehmm_tpu_torch.cli import track_dump as port_dump  # noqa: E402
from tehmm_tpu_torch.cli.unported import SLICE_TOOLS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(capsys, tmp_path, jax_cli, port_cli, argv, output=None):
    """Run the JAX tool and the port's on ``argv`` (an argument "{out}"
    names each tool's own file ``output``); -> [(stdout, file bytes or
    None)] for the JAX tool, then the port's."""
    runs = []
    for tag, cli in (("jax", jax_cli), ("port", port_cli)):
        out = None if output is None else str(tmp_path / f"{tag}_{output}")
        args = [out if a == "{out}" else a for a in argv]
        assert cli.main(args) == 0
        data = None if out is None else open(out, "rb").read()
        runs.append((capsys.readouterr().out, data))
    return runs


def _truth_pred(tmp_path):
    """A truth BED of three states on two chromosomes, and a prediction
    with shifted boundaries, a self-overlap, uncovered truth bases, a
    chromosome the truth lacks and anonymous state names."""
    rng = np.random.RandomState(3)
    truth, pred = [], []
    for chrom in ("chr1", "chr2"):
        pos = 0
        while pos < 5000:
            end = pos + int(rng.randint(50, 400))
            name = ("BG", "TE", "LINE")[rng.randint(3)]
            truth.append((chrom, pos, end, name))
            lo = max(0, pos + int(rng.randint(-5, 6)))
            hi = end + int(rng.randint(-5, 6))
            if rng.rand() < 0.9:
                pred.append((chrom, lo, hi,
                             {"BG": "0", "TE": "1", "LINE": "2"}[name]
                             if rng.rand() < 0.85 else "3"))
            pos = end
    pred.append(("chr1", 100, 180, "1"))
    pred.append(("chr3", 0, 100, "0"))
    t, p = str(tmp_path / "truth.bed"), str(tmp_path / "pred.bed")
    write_bed_intervals(truth, t)
    write_bed_intervals(pred, p)
    named = [(c, s, e, {"0": "BG", "1": "TE", "2": "LINE", "3": "TE"}[n])
             for c, s, e, n in pred]
    n = str(tmp_path / "named.bed")
    write_bed_intervals(named, n)
    return t, p, n


@pytest.mark.parametrize("flags", [[], ["--json"], ["--slack", "5"],
                                   ["--slack", "5", "--json"]],
                         ids=["table", "json", "slack", "slack_json"])
def test_compare_bed_states(tmp_path, capsys, flags):
    truth, _pred, named = _truth_pred(tmp_path)
    (jax_out, _), (port_out, _) = _both(
        capsys, tmp_path, jax_cbs, port_cbs, [truth, named, *flags])
    assert port_out == jax_out
    assert "TE" in port_out
    assert port_cbs.compare_bed_files(truth, named, 5) == \
        jax_cbs.compare_bed_files(truth, named, 5)


@pytest.mark.parametrize("print_map", [False, True],
                         ids=["bed", "printMap"])
def test_fit_state_names(tmp_path, capsys, print_map):
    truth, pred, _named = _truth_pred(tmp_path)
    flags = ["--printMap"] if print_map else []
    (jax_out, jax_f), (port_out, port_f) = _both(
        capsys, tmp_path, jax_fsn, port_fsn,
        [truth, pred, "{out}", *flags], "out.bed")
    assert port_f == jax_f and port_out == jax_out
    assert b"TE" in port_f
    # a prediction name that collides with a truth name gets a suffix
    coll = [("c", 0, 100, "TE"), ("c", 100, 200, "BG")]
    pred2 = [("c", 0, 100, "BG"), ("c", 100, 200, "TE"),
             ("c", 200, 210, "X")]
    assert port_fsn.fit_names(coll, pred2) == jax_fsn.fit_names(coll, pred2)


def _bed_input(tmp_path):
    """Overlapping named records over two chromosomes, one BED3 record."""
    path = tmp_path / "in.bed"
    path.write_text(
        "chr2\t50\t90\tTE\n"
        "chr1\t10\t40\tA\n"
        "chr1\t30\t70\tB\n"
        "chr1\t35\t45\tC\n"
        "chr1\t100\t131\tA\n"
        "chr1\t131\t150\tA\n"
        "chr3\t5\t17\n"
    )
    regions = tmp_path / "regions.bed"
    regions.write_text("chr1\t0\t200\nchr4\t0\t30\n")
    return str(path), str(regions)


BED_TOOLS = {
    "add_gaps": ["add-gaps", "{in}", "{out}"],
    "add_gaps_state": ["add-gaps", "{in}", "{out}", "--state", "BG"],
    "add_gaps_regions": ["add-gaps", "{in}", "{out}", "--state", "BG",
                         "--regions", "{regions}"],
    "remove_overlaps": ["remove-overlaps", "{in}", "{out}"],
    "remove_overlaps_last": ["remove-overlaps", "{in}", "{out}",
                             "--mode", "last"],
    "chunk": ["chunk", "{in}", "{out}", "--maxLen", "7"],
    "add_colors": ["add-colors", "{in}", "{out}"],
    "stats": ["stats", "{in}"],
}


@pytest.mark.parametrize("case", sorted(BED_TOOLS))
def test_bed_tools(tmp_path, capsys, case):
    bed, regions = _bed_input(tmp_path)
    argv = [{"{in}": bed, "{regions}": regions}.get(a, a)
            for a in BED_TOOLS[case]]
    output = "out.bed" if "{out}" in argv else None
    (jax_out, jax_f), (port_out, port_f) = _both(
        capsys, tmp_path, jax_bed, port_bed, argv, output)
    assert port_f == jax_f and port_out == jax_out
    assert port_out or port_f


def test_state_colors_match():
    names = ["TE", "BG", "LINE", "0", "1", ".", "LTR|left"]
    assert [port_bed.state_color(n) for n in names] == \
        [jax_bed.state_color(n) for n in names]


@pytest.mark.parametrize("mode", [["clean-rm"],
                                  ["clean-rm", "--level", "family"],
                                  ["clean-ltr"]],
                         ids=["rm_class", "rm_family", "ltr"])
def test_clean_external(tmp_path, capsys, mode):
    path = tmp_path / "ext.bed"
    path.write_text(
        "chr1\t0\t10\tL1MA4#LINE/L1\n"
        "chr1\t10\t20\tAluY#SINE/Alu\n"
        "chr1\t20\t30\tLTR|left|42\n"
        "chr1\t30\t40\tLTR|right|7|3\n"
        "chr1\t40\t50\tplain\n"
        "chr1\t50\t60\t12\n"
        "chr1\t60\t70\n"
    )
    argv = [mode[0], str(path), "{out}", *mode[1:]]
    (jax_out, jax_f), (port_out, port_f) = _both(
        capsys, tmp_path, jax_clean, port_clean, argv, "out.bed")
    assert port_f == jax_f and port_out == jax_out


@pytest.mark.parametrize("case", [
    "empty", "constant", "small_ints", "unit_interval", "linear", "log",
    "negative",
])
def test_choose_scaling(case):
    rng = np.random.RandomState(1)
    vals = {
        "empty": np.array([]),
        "constant": np.full(10, 2.5),
        "small_ints": rng.randint(0, 5, size=50).astype(float),
        "unit_interval": rng.rand(100),
        "linear": rng.uniform(0, 40, size=100),
        "log": np.exp(rng.uniform(0, 12, size=100)),
        "negative": rng.uniform(-30, 5, size=100),
    }[case]
    for bins in (2, 10):
        assert port_sts.choose_scaling(vals, bins) == \
            jax_sts.choose_scaling(vals, bins)


def _numeric_tracks(tmp_path):
    """A categorical track, a numeric track (valCol 4) with a wide range,
    one with a narrow integer range and a FASTA track."""
    rng = np.random.RandomState(2)
    cat, wide, narrow = [], [], []
    for s in range(0, 3000, 50):
        cat.append(f"chr1\t{s}\t{s + 50}\t{'XY'[rng.randint(2)]}\n")
        wide.append(f"chr1\t{s}\t{s + 40}\tw\t"
                    f"{np.exp(rng.uniform(0, 9)):.3f}\n")
        narrow.append(f"chr1\t{s}\t{s + 50}\tn\t{rng.randint(0, 4)}\n")
    for name, rows in (("cat", cat), ("wide", wide), ("narrow", narrow)):
        (tmp_path / f"{name}.bed").write_text("".join(rows))
    fa = tmp_path / "g.fa"
    fa.write_text(">chr1\n" + "".join(
        "ACGT"[i] for i in rng.randint(0, 4, size=3000)) + "\n")
    xml = tmp_path / "t.xml"
    xml.write_text(
        "<teModelConfig>"
        f'<track name="cat" path="{tmp_path / "cat.bed"}"/>'
        f'<track name="wide" path="{tmp_path / "wide.bed"}" valCol="4"/>'
        f'<track name="narrow" path="{tmp_path / "narrow.bed"}" '
        'valCol="4"/>'
        f'<track name="seq" path="{fa}"/>'
        "</teModelConfig>"
    )
    regions = tmp_path / "r.bed"
    regions.write_text("chr1\t0\t1500\nchr1\t2000\t3000\n")
    return str(xml), str(regions)


@pytest.mark.parametrize("flags", [[], ["--numBins", "4"],
                                   ["--tracks", "wide"]],
                         ids=["default", "bins4", "subset"])
def test_set_track_scaling(tmp_path, capsys, flags):
    xml, regions = _numeric_tracks(tmp_path)
    (jax_out, jax_f), (port_out, port_f) = _both(
        capsys, tmp_path, jax_sts, port_sts,
        [xml, regions, "{out}", *flags], "out.xml")
    assert port_f == jax_f and port_out == jax_out
    assert b"wide" in port_f


def _dump_tracks(tmp_path):
    """A categorical track with gaps and a gaussian track (valCol 4)."""
    rng = np.random.RandomState(4)
    cat, gau = [], []
    for s in range(0, 300, 20):
        if rng.rand() < 0.8:
            cat.append(f"chr1\t{s}\t{s + 20}\t{'ABC'[rng.randint(3)]}\n")
        if rng.rand() < 0.7:
            gau.append(f"chr1\t{s}\t{s + 20}\tg\t{rng.normal():.4f}\n")
    (tmp_path / "cat.bed").write_text("".join(cat))
    (tmp_path / "gau.bed").write_text("".join(gau))
    xml = tmp_path / "t.xml"
    xml.write_text(
        "<teModelConfig>"
        f'<track name="cat" path="{tmp_path / "cat.bed"}"/>'
        f'<track name="gau" path="{tmp_path / "gau.bed"}" '
        'distribution="gaussian" valCol="4"/>'
        "</teModelConfig>"
    )
    regions = tmp_path / "r.bed"
    regions.write_text("chr1\t0\t120\nchr1\t200\t300\n")
    return str(xml), str(regions)


@pytest.mark.parametrize("flags", [[], ["--values"]],
                         ids=["symbols", "values"])
def test_track_dump(tmp_path, capsys, flags):
    xml, regions = _dump_tracks(tmp_path)
    (jax_out, _), (port_out, _) = _both(
        capsys, tmp_path, jax_dump, port_dump, [xml, regions, *flags])
    assert port_out == jax_out
    assert len(port_out.splitlines()) == 221


def test_track_dump_repo_data(capsys):
    """The repo's data: a FASTA track, a binary track, a BED track."""
    data = os.path.join(REPO, "tests", "data")
    outs = []
    for cli in (jax_dump, port_dump):
        assert cli.main([os.path.join(data, "tracks.xml"),
                         os.path.join(data, "regions.bed"),
                         "--values"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert len(outs[1].splitlines()) == 2401


@pytest.mark.parametrize("S", [1, 2, 5])
def test_analysis_matches(S):
    rng = np.random.RandomState(S)
    log_em = np.log(rng.dirichlet(np.ones(4), size=(S, 3)))
    np.testing.assert_array_equal(
        port_analysis.emission_feature_matrix(log_em),
        jax_analysis.emission_feature_matrix(log_em))
    np.testing.assert_array_equal(port_analysis.pca_states(log_em),
                                  jax_analysis.pca_states(log_em))
    got = port_analysis.hierarchical_cluster_states(log_em)
    want = jax_analysis.hierarchical_cluster_states(log_em)
    assert got["order"] == want["order"]
    np.testing.assert_array_equal(got["linkage"], want["linkage"])


# ---------------------------------------------------------------------
# the dispatcher and the entry points
# ---------------------------------------------------------------------

def test_dispatcher_tool_names():
    assert set(port_main.TOOLS) == set(jax_main.TOOLS)
    assert len(port_main.TOOLS) == 15
    for tool, mod in port_main.TOOLS.items():
        if mod is not None:
            assert mod == jax_main.TOOLS[tool].replace(
                "tehmm_tpu.", "tehmm_tpu_torch.", 1)


@pytest.mark.parametrize("argv,rc", [([], 2), (["--help"], 0),
                                     (["-h"], 0), (["nonsense"], 2)],
                         ids=["none", "help", "h", "unknown"])
def test_dispatcher_exit_codes(capsys, argv, rc):
    assert port_main.main(argv) == rc
    port = capsys.readouterr()
    assert jax_main.main(argv) == rc
    ref = capsys.readouterr()
    assert port.out.replace("tehmm_tpu_torch", "tehmm_tpu") == ref.out
    assert port.err == ref.err


def test_dispatcher_runs_tool(tmp_path, capsys):
    bed = tmp_path / "x.bed"
    bed.write_text("c\t0\t10\tA\nc\t20\t25\tB\n")
    assert port_main.main(["bed-tools", "stats", str(bed)]) == 0
    assert json.loads(capsys.readouterr().out)["A"]["total_bases"] == 10


@pytest.mark.parametrize("tool", ["tsd-finder", "add-tsd-track",
                                  "import-model"])
def test_part_b_tools_name_their_slice(tool):
    assert port_main.TOOLS[tool] is None
    with pytest.raises(SystemExit) as exc:
        port_main.main([tool, "x"])
    assert SLICE_TOOLS in str(exc.value.code)
    assert SLICE_TOOLS == "ROADMAP Queue 1, slice 8: utilities"


def test_dispatcher_closed_pipe_exits_141(tmp_path):
    """A reader that closes the pipe early: no traceback, exit 141."""
    bed = tmp_path / "many.bed"
    bed.write_text("".join(f"c\t{i}\t{i + 1}\tstate{i}\n"
                           for i in range(5000)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tehmm_tpu_torch", "bed-tools", "stats",
         str(bed)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    proc.stdout.close()
    err = proc.stderr.read()
    assert proc.wait(timeout=120) == 141, err
    assert b"Traceback" not in err


def _public_entries(mod):
    return {n for n, f in vars(mod).items()
            if callable(f) and not n.startswith("_")
            and not inspect.ismodule(f)
            and getattr(f, "__module__", mod.__name__) == mod.__name__}


def test_entrypoints_cover_the_reference():
    assert _public_entries(port_entry) == _public_entries(jax_entry)
    assert "te_hmm_train" in _public_entries(port_entry)


def test_entrypoint_runs_subtool(tmp_path, capsys, monkeypatch):
    bed = tmp_path / "x.bed"
    bed.write_text("c\t0\t10\tA\n")
    monkeypatch.setattr(sys, "argv", ["bedStats", str(bed)])
    assert port_entry.bed_stats() == 0
    assert json.loads(capsys.readouterr().out)["A"]["count"] == 1
    monkeypatch.setattr(sys, "argv", ["tsdFinder", "x"])
    with pytest.raises(SystemExit) as exc:
        port_entry.tsd_finder()
    assert SLICE_TOOLS in str(exc.value.code)
