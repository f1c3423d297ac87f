"""The port's own host layer (``tehmm_tpu_torch.io``, ``.native``,
``.utils.common``) against the JAX package's, on the CPU.

The port keeps a copy of every host module it needs (it imports nothing
of ``tehmm_tpu``), so the copies are held to the originals: the same
tables, gaussian values, category maps and segments from the same files,
and the same outputs from every native entry point.  The one intended
difference is in the port's ``tehmm_native.cpp``: ``bin_scale_f64``'s
presence flags are stored with relaxed atomics, which changes no
result, at any thread count."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu import native as jnative  # noqa: E402
from tehmm_tpu import io as jio  # noqa: E402
from tehmm_tpu.io import priors as jpriors  # noqa: E402
from tehmm_tpu.io import segments as jsegments  # noqa: E402
from tehmm_tpu.io.bigwig import BigWigFile as JBigWig  # noqa: E402
from tehmm_tpu.io.bigwig_writer import write_bigwig  # noqa: E402
from tehmm_tpu.utils import common as jcommon  # noqa: E402
from tehmm_tpu_torch import io as tio  # noqa: E402
from tehmm_tpu_torch import native as tnative  # noqa: E402
from tehmm_tpu_torch.io import priors as tpriors  # noqa: E402
from tehmm_tpu_torch.io import segments as tsegments  # noqa: E402
from tehmm_tpu_torch.io.bigwig import BigWigFile as TBigWig  # noqa: E402
from tehmm_tpu_torch.utils import common as tcommon  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _assert_tables_equal(got, want):
    assert len(got.tables) == len(want.tables)
    for g, w in zip(got.tables, want.tables):
        assert (g.chrom, g.start, g.end) == (w.chrom, w.start, w.end)
        assert g.symbols.dtype == w.symbols.dtype
        np.testing.assert_array_equal(g.symbols, w.symbols)
        if w.values is None:
            assert g.values is None
        else:
            np.testing.assert_array_equal(g.values, w.values)
    assert got.alphabet_sizes == want.alphabet_sizes
    assert got.gauss_track_indices == want.gauss_track_indices
    assert {k: v.to_dict() for k, v in got.category_maps.items()} == \
        {k: v.to_dict() for k, v in want.category_maps.items()}


@pytest.fixture
def gauss_dir(tmp_path):
    """Categorical BED, a gaussian BED track (NaN gaps) and a BigWig
    track with scaling, over two chromosomes."""
    rng = np.random.RandomState(3)
    L = 3000
    cat, gau = [], []
    for chrom in ("chr1", "chr2"):
        pos = 0
        while pos < L:
            end = min(pos + rng.randint(20, 90), L)
            cat.append((chrom, pos, end, "ABC"[rng.randint(3)]))
            pos = end
        for i in range(0, L, 25):
            if rng.rand() < 0.8:
                gau.append((chrom, i, i + 25, "x",
                            f"{rng.normal(2.0, 1.5):.4f}"))
    jio.write_bed_intervals(cat, str(tmp_path / "cat.bed"))
    with open(tmp_path / "g.bed", "w") as fh:
        for r in gau:
            fh.write("\t".join(map(str, r)) + "\n")
    write_bigwig(str(tmp_path / "s.bw"), {"chr1": L, "chr2": L},
                 [(c, s, s + 40, float(rng.rand() * 30))
                  for c in ("chr1", "chr2") for s in range(0, L, 50)])
    xml = tmp_path / "t.xml"
    xml.write_text(
        "<teModelConfig>"
        f'<track name="c" path="{tmp_path / "cat.bed"}"/>'
        f'<track name="g" path="{tmp_path / "g.bed"}" '
        'distribution="gaussian" valCol="4"/>'
        f'<track name="w" path="{tmp_path / "s.bw"}" scale="0.5"/>'
        "</teModelConfig>"
    )
    return tmp_path, str(xml)


def test_tests_data_loads_identically():
    xml = os.path.join(DATA, "tracks.xml")
    regions = jio.read_bed_intervals(os.path.join(DATA, "regions.bed"),
                                     ncol=3)
    assert tio.read_bed_intervals(os.path.join(DATA, "regions.bed"),
                                  ncol=3) == regions
    want = jio.load_track_data(jio.TrackList(xml), regions)
    got = tio.load_track_data(tio.TrackList(xml), regions)
    _assert_tables_equal(got, want)
    # with the category maps of a model, as eval loads them
    got2 = tio.load_track_data(tio.TrackList(xml), regions,
                               category_maps=got.category_maps)
    _assert_tables_equal(got2, want)
    assert tio.get_merged_bed_intervals(os.path.join(DATA, "truth.bed")) \
        == jio.get_merged_bed_intervals(os.path.join(DATA, "truth.bed"))


def test_gaussian_and_bigwig_tracks_load_identically(gauss_dir):
    tmp, xml = gauss_dir
    regions = [("chr1", 0, 3000), ("chr2", 100, 2900)]
    want = jio.load_track_data(jio.TrackList(xml), regions)
    got = tio.load_track_data(tio.TrackList(xml), regions)
    assert want.gauss_track_indices == [1]
    _assert_tables_equal(got, want)
    assert np.isnan(got.tables[0].values).any()
    assert tio.TrackList(xml).to_dicts() == jio.TrackList(xml).to_dicts()
    with JBigWig(str(tmp / "s.bw")) as jb, TBigWig(str(tmp / "s.bw")) as tb:
        np.testing.assert_array_equal(tb.values("chr2", 10, 1990),
                                      jb.values("chr2", 10, 1990))
        assert tb.intervals("chr1", 0, 300) == jb.intervals("chr1", 0, 300)


def test_segments_load_identically(gauss_dir):
    _tmp, xml = gauss_dir
    segs = [("chr1", s, min(s + 37, 3000)) for s in range(0, 3000, 37)]
    segs += [("chr2", 500, 700), ("chr2", 700, 701), ("chr2", 900, 950)]
    jtd, jsegs = jsegments.load_segment_data(jio.TrackList(xml), segs)
    ttd, tsegs = tsegments.load_segment_data(tio.TrackList(xml), segs)
    _assert_tables_equal(ttd, jtd)
    assert len(tsegs) == len(jsegs) == 3
    path = np.arange(len(tsegs[0].symbols)) % 3
    for t, j in zip(tsegs, jsegs):
        assert (t.chrom, t.start, t.end) == (j.chrom, j.start, j.end)
        for name in ("symbols", "seg_bounds", "lengths", "values"):
            np.testing.assert_array_equal(getattr(t, name),
                                          getattr(j, name))
    names = ["a", "b", "c"]
    assert tsegments.expand_path(tsegs[0], path, names) == \
        jsegments.expand_path(jsegs[0], path, names)


def test_priors_read_identically(tmp_path):
    xml = os.path.join(DATA, "tracks.xml")
    trans = tmp_path / "t.txt"
    trans.write_text("TE\tBG\t0.1\nTE\tTE\t0.9\nBG\tTE\t0.05\n")
    em = tmp_path / "e.txt"
    em.write_text("TE\tfamily\tL1\t0.7\nBG\tseq\tA\t0.25\n")
    names = jpriors.collect_state_names([str(trans)], [str(em)])
    assert tpriors.collect_state_names([str(trans)], [str(em)]) == names
    np.testing.assert_array_equal(
        tpriors.read_trans_prior(str(trans), names),
        jpriors.read_trans_prior(str(trans), names))
    regions = [("chr1", 0, 500)]
    jtd = jio.load_track_data(jio.TrackList(xml), regions)
    ttd = tio.load_track_data(tio.TrackList(xml), regions)
    want = jpriors.read_em_prior(str(em), names, jtd.track_list,
                                 jtd.category_maps)
    got = tpriors.read_em_prior(str(em), names, ttd.track_list,
                                ttd.category_maps)
    np.testing.assert_array_equal(got, want)
    tp = tpriors.read_trans_prior(str(trans), names)
    np.testing.assert_array_equal(tpriors.prior_to_init(tp),
                                  jpriors.prior_to_init(tp))


def test_common_constants_and_logger():
    assert (tcommon.EPSILON, tcommon.LOG_ZERO) == \
        (jcommon.EPSILON, jcommon.LOG_ZERO)
    assert tcommon.logger.name == "tehmm_tpu_torch"


def test_native_builds_into_the_port_build_dir():
    assert tnative.available()
    assert tnative.BUILD_DIR.endswith(os.path.join("build",
                                                   "tehmm_tpu_torch"))
    assert any(f.startswith("tehmm_native-")
               for f in os.listdir(tnative.BUILD_DIR))


def _bed_file(tmp_path):
    path = str(tmp_path / "n.bed")
    with open(path, "w") as fh:
        fh.write("chr1\t0\t10\tA\t5\nchr1\t12\t20\tB\t1.5\n"
                 "chr2\t3\t9\tA\t-2\n")
    return path


def _native_cases(tmp_path):
    """(name, args) per native entry point, inputs made from a seed."""
    rng = np.random.RandomState(11)
    states = rng.randint(0, 4, 500).astype(np.int32)
    symbols = rng.randint(0, 6, (500, 3)).astype(np.uint16)
    vals = rng.randn(20000) * 40
    vals[::9] = np.nan
    fasta = str(tmp_path / "g.fa")
    with open(fasta, "w") as fh:
        fh.write(">c1\nACGTACGTAC\nGTAC\n>c2\nNNNNACGT\n")
    return {
        "parse_bed_columnar": (_bed_file(tmp_path),),
        "parse_bed_columnar_score": (_bed_file(tmp_path), 4),
        "count_transitions": (states, 4),
        "count_emissions": (states, symbols, 4, 6),
        "runs_encode": (np.repeat(rng.randint(0, 3, 60), 7),),
        "fasta_index": (fasta,),
        "bin_scale": (vals, 0.5, 0.25, None, -30, 60),
        "bin_scale_log": (vals, 50.0, None, 2.0, -10, 40),
        "nanminmax": (vals,),
    }


def _call(mod, name, args):
    fn = name.replace("_score", "").replace("_log", "")
    return getattr(mod, fn)(*args)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", [
    "parse_bed_columnar", "parse_bed_columnar_score", "count_transitions",
    "count_emissions", "runs_encode", "fasta_index", "bin_scale",
    "bin_scale_log", "nanminmax", "fill_intervals", "pack_columns",
    "bigwig_paint_blocks",
])
def test_native_entry_points_match_reference(tmp_path, name):
    if name == "fill_intervals":
        got = np.zeros(50, np.uint16)
        want = np.zeros(50, np.uint16)
        args = (0, np.array([2, 10, 40]), np.array([5, 30, 60]),
                np.array([1, 2, 3]))
        assert tnative.fill_intervals(got, *args)
        assert jnative.fill_intervals(want, *args)
        np.testing.assert_array_equal(got, want)
        return
    if name == "pack_columns":
        rng = np.random.RandomState(2)
        for dtype in (np.uint16, np.float32):
            cols = [rng.randint(0, 9, 777).astype(dtype) for _ in range(4)]
            got = np.zeros((777, 4), dtype)
            want = np.zeros((777, 4), dtype)
            assert tnative.pack_columns(cols, got, n_threads=3)
            assert jnative.pack_columns(cols, want, n_threads=3)
            np.testing.assert_array_equal(got, want)
        return
    if name == "bigwig_paint_blocks":
        path = str(tmp_path / "b.bw")
        write_bigwig(path, {"c": 5000},
                     [("c", s, s + 7, float(s)) for s in range(0, 5000, 9)])
        with TBigWig(path) as tb, JBigWig(path) as jb:
            np.testing.assert_array_equal(tb.values("c", 3, 4990),
                                          jb.values("c", 3, 4990))
        return
    args = _native_cases(tmp_path)[name]
    _equal(_call(tnative, name, args), _call(jnative, name, args))


@pytest.mark.parametrize("n_threads", [1, 2, 5, 8])
def test_bin_scale_threads_give_reference_bins_and_flags(n_threads):
    """The presence flags are written by every thread (relaxed atomic
    stores in the port's copy): any thread count gives the reference's
    bins and flags."""
    rng = np.random.RandomState(4)
    vals = np.concatenate([rng.randn(50000) * 25, [np.nan] * 100,
                           rng.randint(-5, 5, 30000).astype(float)])
    rng.shuffle(vals)
    want_bins, want_present = jnative.bin_scale(vals, 0.0, 1.0, None, -120,
                                                240, n_threads=1)
    got_bins, got_present = tnative.bin_scale(vals, 0.0, 1.0, None, -120,
                                              240, n_threads=n_threads)
    np.testing.assert_array_equal(got_bins, want_bins)
    np.testing.assert_array_equal(got_present, want_present)
