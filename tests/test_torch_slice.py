"""The port's supervised-train -> Viterbi-eval slice against the JAX
package: the CLIs on the bundled fixtures, model files across packages,
and the stitched and exact decoders on multi-chunk inputs."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.cli import eval as jax_eval  # noqa: E402
from tehmm_tpu.cli import train as jax_train  # noqa: E402
from tehmm_tpu.models.emission import track_log_likelihoods  # noqa: E402
from tehmm_tpu.models.params import HmmParams  # noqa: E402
from tehmm_tpu.ops import dp as jdp  # noqa: E402
from tehmm_tpu.parallel import chunking as jchunking  # noqa: E402
from tehmm_tpu.parallel import stitch as jstitch  # noqa: E402
from tehmm_tpu_torch.cli import eval as port_eval  # noqa: E402
from tehmm_tpu_torch.cli import train as port_train  # noqa: E402
from tehmm_tpu_torch.models.params import from_numpy  # noqa: E402
from tehmm_tpu_torch.parallel import chunking as tchunking  # noqa: E402
from tehmm_tpu_torch.parallel import stitch as tstitch  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_BED = os.path.join(DATA, "golden", "viterbi.bed")
CPU = torch.device("cpu")


@pytest.fixture
def workdir(tmp_path):
    """Copy fixtures so relative track paths in the XML resolve."""
    for f in os.listdir(DATA):
        src = os.path.join(DATA, f)
        if os.path.isfile(src):
            shutil.copy(src, tmp_path / f)
    return tmp_path


def _train(cli, workdir, name, extra=()):
    path = str(workdir / name)
    rc = cli.main([str(workdir / "tracks.xml"), str(workdir / "truth.bed"),
                   path, "--supervised", *extra])
    assert rc == 0
    return path


def _eval(cli, workdir, model, name, extra=()):
    out = str(workdir / name)
    rc = cli.main([str(workdir / "tracks.xml"), model,
                   str(workdir / "regions.bed"), "--bed", out, *extra])
    assert rc == 0
    return open(out).read()


@pytest.mark.parametrize("flags", [
    [],                                              # auto: exact
    ["--exact", "--chunk", "500"],
    ["--no-exact", "--chunk", "300", "--halo", "32"],
])
def test_port_cli_reproduces_golden_bed(workdir, flags):
    model = _train(port_train, workdir, "port.npz", ["--device", "cpu"])
    got = _eval(port_eval, workdir, model, "port.bed",
                ["--device", "cpu", *flags])
    assert got == open(GOLDEN_BED).read()


def test_model_files_decode_alike_in_both_packages(workdir, capsys):
    jax_model = _train(jax_train, workdir, "jax.npz")
    port_model = _train(port_train, workdir, "port.npz",
                        ["--device", "cpu"])
    jz, pz = np.load(jax_model), np.load(port_model)
    for k in ("log_start", "log_trans", "log_em"):
        np.testing.assert_allclose(pz[k], jz[k], rtol=1e-6, atol=1e-6)
    assert bytes(pz["meta"]) == bytes(jz["meta"])

    capsys.readouterr()
    jj = _eval(jax_eval, workdir, jax_model, "jj.bed")
    jax_score = float(capsys.readouterr().out.strip())
    pj = _eval(port_eval, workdir, jax_model, "pj.bed", ["--device", "cpu"])
    port_score = float(capsys.readouterr().out.strip())
    jp = _eval(jax_eval, workdir, port_model, "jp.bed")
    pp = _eval(port_eval, workdir, port_model, "pp.bed",
               ["--device", "cpu"])
    assert jj == pj == jp == pp == open(GOLDEN_BED).read()
    np.testing.assert_allclose(port_score, jax_score, rtol=1e-9)

    # the library entry point gives the same intervals in both packages
    from tehmm_tpu.io import TrackList, load_track_data
    from tehmm_tpu.models.hmm import MultitrackHmm as JaxHmm
    from tehmm_tpu_torch.models.hmm import MultitrackHmm as PortHmm

    jm, pm = JaxHmm.load(jax_model), PortHmm.load(jax_model, CPU)
    data = load_track_data(TrackList(str(workdir / "tracks.xml")),
                           [("chr1", 0, 2400)],
                           category_maps=pm.category_maps)
    assert pm.decode_to_bed(data.tables, chunk_len=500, halo=32) == \
        jm.decode_to_bed(data.tables, chunk_len=500, halo=32)


def test_cli_refuses_what_is_not_ported(workdir, monkeypatch):
    xml, bed = str(workdir / "tracks.xml"), str(workdir / "truth.bed")
    with pytest.raises(SystemExit, match="--cfg.*ROADMAP.*slice 5"):
        port_train.main([xml, bed, str(workdir / "m.npz"), "--cfg"])
    with pytest.raises(SystemExit, match="--mesh.*ROADMAP.*slice 6"):
        port_train.main([xml, bed, str(workdir / "m.npz"), "--numStates",
                         "3", "--mesh", "2"])
    model = _train(port_train, workdir, "m.npz", ["--device", "cpu"])
    regions = str(workdir / "regions.bed")
    # --segment runs and writes the JAX CLI's BED
    seg = _eval(port_eval, workdir, model, "seg_port.bed",
                ["--segment", "--device", "cpu"])
    assert seg == _eval(jax_eval, workdir, model, "seg_jax.bed",
                        ["--segment"])
    with pytest.raises(SystemExit, match="--mesh.*ROADMAP.*slice 6"):
        port_eval.main([xml, model, regions, "--device", "cpu", "--mesh",
                        "2"])
    # CUDA asked for on a host without it raises; nothing picks the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_eval.main([xml, model, regions, "--bed", "o.bed"])


def _sticky_model(rng, S, T, V):
    trans = rng.dirichlet(np.ones(S), size=S) * 0.1 + np.eye(S) * 0.9
    log_em = np.zeros((S, T, V), np.float32)
    for t in range(T):
        log_em[:, t, 1:] = np.log(rng.dirichlet(np.ones(V - 1) * 0.5,
                                                size=S))
    return (np.log(np.full(S, 1.0 / S)).astype(np.float32),
            np.log(trans).astype(np.float32), log_em)


def _planted(rng, log_em, L):
    """Symbols drawn from the model's emissions along a sticky path."""
    S, T, V = log_em.shape
    states = np.repeat(rng.randint(0, S, size=L // 200 + 1), 200)[:L]
    p = np.exp(log_em[states])                       # [L, T, V]
    p[..., 0] = 0.0                                  # never missing
    u = rng.rand(L, T, 1)
    return (p.cumsum(axis=-1) < u).sum(axis=-1).clip(0, V - 1) \
        .astype(np.uint8)


def _mono(jparams, sym):
    obs = track_log_likelihoods(jparams.log_em, jnp.asarray(sym))[None]
    path, _ = jdp.viterbi(jparams.log_start, jparams.log_trans, obs)
    return np.asarray(path[0])


def test_multichunk_decoders_match_reference(rng):
    """2 tables x 20K positions, S=10, T=5: stitched (chunk 1024, halo
    64) and exact decodes equal the JAX package's, and the monolithic
    decode."""
    tables = _sticky_model(rng, 10, 5, 9)
    jparams = HmmParams(*(jnp.asarray(x) for x in tables))
    tparams = from_numpy(*tables, CPU)
    syms = [_planted(rng, tables[2], 20_000),
            _planted(rng, tables[2], 19_000)]
    assert all(s.min() >= 1 for s in syms)

    want, jrep = jstitch.viterbi_chunked(jparams, syms, chunk_len=1024,
                                         halo=64)
    got, trep = tstitch.viterbi_chunked(tparams, syms, chunk_len=1024,
                                        halo=64)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert trep.n_chunks == 39 and trep.boundaries_ok
    want_x = jstitch.viterbi_exact(jparams, syms, chunk_len=1024)
    got_x = tstitch.viterbi_exact(tparams, syms, chunk_len=1024)
    for sym, w, g, wx, gx in zip(syms, want, got, want_x, got_x):
        mono = _mono(jparams, sym)
        for path in (g, wx, gx):
            np.testing.assert_array_equal(path, w)
        np.testing.assert_array_equal(w, mono)


def _near_tie_model():
    """Sticky transitions over near-uniform emissions: each decision
    depends on evidence far beyond any small halo."""
    log_em = np.zeros((2, 1, 3), np.float32)
    log_em[:, 0, 1:] = np.log(np.array([[0.51, 0.49], [0.49, 0.51]]))
    log_trans = np.log(np.array([[0.99, 0.01], [0.01, 0.99]]))
    return (np.log([0.5, 0.5]).astype(np.float32),
            log_trans.astype(np.float32), log_em)


def test_forced_exact_fallback_matches_reference(rng):
    """A near-tie model whose boundaries never agree within a small
    max_halo: both packages fall back to the exact decoder and give the
    monolithic path."""
    tables = _near_tie_model()
    jparams = HmmParams(*(jnp.asarray(x) for x in tables))
    sym = (rng.randint(0, 2, size=(800, 1)) + 1).astype(np.uint8)
    kw = dict(chunk_len=100, halo=4, max_halo=16, rows_per_pass=4)
    want, jrep = jstitch.viterbi_chunked(jparams, [sym], **kw)
    got, trep = tstitch.viterbi_chunked(from_numpy(*tables, CPU), [sym],
                                        **kw)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert trep.retries >= 1 and trep.final_halo == 16
    assert trep.boundaries_ok
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], _mono(jparams, sym))


def test_stitcher_exact_fallback_branch(rng):
    """The stitching driver with a decoder that never agrees across
    chunks widens every boundary to the cap, keeps capped failures
    failing and hands the input to the exact decoder — exactly as the
    JAX driver does with the same stubs."""
    tables = _near_tie_model()
    sym = (rng.randint(0, 2, size=(500, 1)) + 1).astype(np.uint8)
    sentinel = np.full(500, 3, np.int32)

    def run(stitch, params):
        counter = [0]

        def decode_rows(symbols, lens, *_streams):
            n, L, _ = symbols.shape
            out = np.empty((n, L), np.int32)
            for k in range(n):
                counter[0] += 1
                out[k] = counter[0] % 7
            return out

        def exact_fn(params, tables, chunk_len, **_kw):
            return [sentinel.copy()]

        kw = {} if stitch is tstitch else dict(weight_arrays=None,
                                              gauss_params=None)
        return stitch._stitched_decode(
            params, [sym], chunk_len=100, halo=4, max_halo=8,
            agree_frac=0.5, decode_rows=decode_rows, exact_fn=exact_fn,
            name="test", **kw,
        )

    want, jrep = run(jstitch, HmmParams(*(jnp.asarray(x) for x in tables)))
    got, trep = run(tstitch, from_numpy(*tables, CPU))
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert trep.retries >= 1 and trep.final_halo == 8
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("lengths,chunk,halo", [
    ([1000, 1, 0, 2500], 256, 64),
    ([4096], 4096, 256),
    ([5000, 7], 1024, 0),
])
def test_chunking_copy_matches_reference(rng, lengths, chunk, halo):
    mats = [rng.randint(0, 9, size=(n, 3)).astype(np.uint8)
            for n in lengths]
    want = jchunking.plan_chunks(lengths, chunk, halo)
    got = tchunking.plan_chunks(lengths, chunk, halo)
    assert [dataclasses.astuple(c) for c in got] == \
        [dataclasses.astuple(c) for c in want]
    jb = jchunking.batch_chunks(mats, want)
    tb = tchunking.batch_chunks(mats, got)
    np.testing.assert_array_equal(tb.symbols, jb.symbols)
    np.testing.assert_array_equal(tb.lengths, jb.lengths)
