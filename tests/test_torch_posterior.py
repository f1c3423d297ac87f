"""The port's max-posterior decoding, posterior distributions and
scoring against the JAX package: the carried chunk continuations, the
plain K4 decode against the Pallas kernel (interpret mode), the stitched
and exact decoders, ``MultitrackHmm.score``, and the eval CLI's
``--maxPost``, ``--pd`` and scoring-only modes."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.cli import eval as jax_eval  # noqa: E402
from tehmm_tpu.io.category import CategoryMap  # noqa: E402
from tehmm_tpu.io.trackdata import TrackTable  # noqa: E402
from tehmm_tpu.io.trackxml import Track, TrackList  # noqa: E402
from tehmm_tpu.models.emission import track_log_likelihoods  # noqa: E402
from tehmm_tpu.models.hmm import MultitrackHmm as JaxHmm  # noqa: E402
from tehmm_tpu.models.params import HmmParams  # noqa: E402
from tehmm_tpu.ops import dp as jdp  # noqa: E402
from tehmm_tpu.ops import pallas_kernels as pk  # noqa: E402
from tehmm_tpu.parallel import stitch as jstitch  # noqa: E402
from tehmm_tpu_torch.cli import eval as port_eval  # noqa: E402
from tehmm_tpu_torch.cli import train as port_train  # noqa: E402
from tehmm_tpu_torch.models import emission as tem  # noqa: E402
from tehmm_tpu_torch.models.hmm import MultitrackHmm as PortHmm  # noqa: E402
from tehmm_tpu_torch.models.params import from_numpy  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp as tdp  # noqa: E402
from tehmm_tpu_torch.parallel import stitch as tstitch  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
CPU = torch.device("cpu")

# (S, L, lengths, zero_trans_frac): ragged rows incl. 0 and 1
CASES = [
    (3, 23, [23, 11, 1, 0], 0.0),
    (10, 23, [23, 11, 1, 0], 0.0),
    (3, 17, [17, 9, 2, 0], 0.5),             # LOG_ZERO transitions
    (10, 1, [1, 0, 1], 0.0),
]


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(rng, make_hmm, S, L, lengths, zero_frac):
    ls, lt, _ = make_hmm(S, 2, 4, zero_trans_frac=zero_frac)
    B = len(lengths)
    obs = (rng.randn(B, L, S) * 2.0).astype(np.float32)
    init = rng.randn(B, S).astype(np.float32)
    init -= init.max(axis=-1, keepdims=True)            # a carry: max 0
    return (ls.astype(np.float32), lt.astype(np.float32), obs,
            np.asarray(lengths, np.int32), init)


@pytest.fixture(autouse=True)
def _nothing_launches():
    ck.reset_launch_counts()
    yield
    # nothing on the CPU may launch (or build) a kernel
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES


# ---------------------------------------------------------------------
# the carried chunk continuations
# ---------------------------------------------------------------------

@pytest.mark.parametrize("S,L,lengths,zero_frac", CASES)
def test_chunk_continuations_match_reference(rng, make_hmm, S, L, lengths,
                                             zero_frac):
    """forward_final, forward_chunk_values, backward_chunk_values and
    streaming_loglik against the JAX package's on the same obs: hats
    within 1e-5, logliks within 1e-6 relative."""
    ls, lt, obs, lens, init = _setup(rng, make_hmm, S, L, lengths,
                                     zero_frac)
    j = dict(lt=jnp.asarray(lt), obs=jnp.asarray(obs),
             init=jnp.asarray(init), lens=jnp.asarray(lens))
    cont = np.asarray([True, False] * len(lens))[: len(lens)]

    want_c, want_dm = jdp.forward_final(j["lt"], j["obs"], j["init"],
                                        j["lens"])
    got_c, got_dm = tdp.forward_final(_t(lt), _t(obs), _t(init), _t(lens))
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_dm.numpy(), want_dm, rtol=1e-6,
                               atol=1e-6)

    want_h, want_f = jdp.forward_chunk_values(j["lt"], j["obs"], j["init"],
                                              j["lens"])
    got_h, got_f = tdp.forward_chunk_values(_t(lt), _t(obs), _t(init),
                                            _t(lens))
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=0, atol=1e-5)
    assert torch.equal(got_f, got_c)

    want_b, want_x = jdp.backward_chunk_values(
        j["lt"], j["obs"], j["init"], jnp.asarray(cont), j["lens"])
    got_b, got_x = tdp.backward_chunk_values(_t(lt), _t(obs), _t(init),
                                             _t(cont), _t(lens))
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0, atol=1e-5)

    # the whole rows' loglik, streamed in chunks of 6 (rows end
    # mid-stream; zero-length rows give 0)
    chunks = [obs[:, lo : lo + 6] for lo in range(0, L, 6)]
    chunk_lens = [np.clip(lens - lo, 0, 6) for lo in range(0, L, 6)]
    want = np.asarray(jdp.streaming_loglik(
        jnp.asarray(ls), j["lt"], [jnp.asarray(c) for c in chunks],
        chunk_lens,
    ))
    got = tdp.streaming_loglik(_t(ls), _t(lt), [_t(c) for c in chunks],
                               chunk_lens).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[lens == 0] == 0.0).all()
    full = tdp.forward_scaled(_t(ls), _t(lt), _t(obs), _t(lens))[2]
    np.testing.assert_allclose(got, full.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("Lc", [1, 4, 7, 40])
def test_chunked_sweeps_bit_equal_monolithic(rng, make_hmm, Lc):
    """The port's chunk continuations, stitched chunk by chunk, give the
    bits of its own monolithic forward_scaled / backward_scaled."""
    S, L = 6, 40
    ls, lt, obs, lens, _ = _setup(rng, make_hmm, S, L, [40, 27, 13, 1, 0],
                                  0.3)
    ls, lt, obs, lens = _t(ls), _t(lt), _t(obs), _t(lens)
    ah, _, _ = tdp.forward_scaled(ls, lt, obs, lens)
    bh, _ = tdp.backward_scaled(lt, obs, lens)
    B = len(lens)
    starts = list(range(1, L, Lc))

    def chunk(lo):
        block = torch.zeros((B, Lc, S))
        piece = obs[:, lo : lo + Lc]
        block[:, : piece.shape[1]] = piece
        return block, torch.clamp(lens - lo, 0, Lc).to(torch.int32)

    a, hats = ah[:, 0], []
    for lo in starts:
        block, cl = chunk(lo)
        if lo == 1:
            carry, _ = tdp.forward_final(lt, block, a, cl)
        h, a = tdp.forward_chunk_values(lt, block, a, cl)
        if lo == 1:
            assert torch.equal(carry, a)
        hats.append(h)
    assert torch.equal(torch.cat(hats, dim=1)[:, : L - 1], ah[:, 1:])

    x, betas = torch.zeros((B, S)), []
    for lo in reversed(starts):
        block, cl = chunk(lo)
        b, x = tdp.backward_chunk_values(lt, block, x, lens > lo + Lc, cl)
        betas.insert(0, b)
    b0, _ = tdp.backward_chunk_values(lt, torch.zeros((B, 1, S)), x,
                                      lens > 1, torch.ones(B, dtype=torch.int32))
    got = torch.cat([b0] + betas, dim=1)[:, :L]
    assert torch.equal(got, bh)


# ---------------------------------------------------------------------
# K4: the plain decode against the Pallas kernel
# ---------------------------------------------------------------------

@pytest.mark.parametrize("S,T,V,lengths", [
    (5, 3, 6, [37, 28, 1, 0]),
    (20, 5, 8, [64, 40, 64]),
])
def test_k4_plain_matches_pallas_v4(rng, make_hmm, S, T, V, lengths):
    """posterior_decode_fused on CPU tensors (the plain K4) gives the
    paths of posterior_decode_fused_pallas_v4 in interpret mode, and
    the argmax of the log-space posteriors."""
    ls, lt, lem = (x.astype(np.float32) for x in make_hmm(S, T, V))
    L = max(lengths)
    sym = rng.randint(0, V, size=(len(lengths), L, T)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(pk.posterior_decode_fused_pallas_v4(
        jnp.asarray(ls), jnp.asarray(lt), jnp.asarray(lem),
        jnp.asarray(sym), jnp.asarray(lens),
    ))
    got = ck.posterior_decode_fused(_t(ls), _t(lt), _t(lem), _t(sym),
                                    _t(lens))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    path, margin = ck.post_decode_plain(
        _t(lt), _t(lem), _t(sym), _t(lens),
        ck.em_fwd(_t(ls), _t(lt), _t(lem), _t(sym), _t(lens))[0],
        with_margin=True,
    )
    assert torch.equal(path, got)
    assert margin.shape == path.shape and (margin >= 0).all()
    obs = track_log_likelihoods(jnp.asarray(lem), jnp.asarray(sym))
    ah, _, _ = jdp.forward_scaled(jnp.asarray(ls), jnp.asarray(lt), obs,
                                  jnp.asarray(lens))
    bh, _ = jdp.backward_scaled(jnp.asarray(lt), obs, jnp.asarray(lens))
    xla = np.asarray(jnp.argmax(jdp.posterior_scaled(ah, bh), axis=-1))
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(got.numpy()[b, :n], xla[b, :n])
        assert (got.numpy()[b, n:] == 0).all()


def test_posterior_wrappers_check_their_arguments(rng, make_hmm):
    ls, lt, lem = (_t(x.astype(np.float32)) for x in make_hmm(4, 2, 5))
    sym = _t(rng.randint(0, 5, size=(3, 9, 2)).astype(np.int32))
    lens = _t(np.asarray([9, 4, 0], np.int32))
    alpha = ck.em_fwd(ls, lt, lem, sym, lens)[0]
    with pytest.raises(ValueError, match="alpha"):
        ck.post_decode(lt, lem, sym, lens, alpha[:, :-1])
    obs, carry = torch.zeros((3, 9, 4)), torch.zeros((3, 4))
    with pytest.raises(TypeError, match="lengths"):
        ck.forward_final(lt, obs, carry, lens.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        ck.forward_chunk_values(lt, obs.transpose(0, 1).contiguous()
                                .transpose(0, 1), carry, lens)
    with pytest.raises(TypeError, match="continuing"):
        ck.backward_chunk_values(lt, obs, carry, lens, lens)
    with pytest.raises(ValueError, match="at least one position"):
        ck.backward_chunk_values(lt, obs[:, :0], carry,
                                 torch.zeros(3, dtype=torch.bool), lens)
    # CPU tensors take the plain versions, bit for bit
    cont = torch.tensor([True, False, False])
    assert all(torch.equal(g, w) for g, w in zip(
        ck.backward_chunk_values(lt, obs, carry, cont, lens),
        tdp.backward_chunk_values(lt, obs, carry, cont, lens)))
    assert all(torch.equal(g, w) for g, w in zip(
        ck.forward_final(lt, obs, carry, lens),
        tdp.forward_final(lt, obs, carry, lens)))
    assert ck._lib is None


# ---------------------------------------------------------------------
# the decoders, posterior distributions and score
# ---------------------------------------------------------------------

def _both(log_start, log_trans, log_em):
    tables = [np.asarray(x, np.float32) for x in (log_start, log_trans,
                                                  log_em)]
    return (HmmParams(*(jnp.asarray(x) for x in tables)),
            from_numpy(*tables, CPU))


def _adversarial(rng, L):
    """Near-uniform emissions: the posterior argmax rides thin margins,
    so halo forgetting never converges."""
    log_em = np.zeros((2, 1, 3), np.float32)
    log_em[:, 0, 1:] = np.log(np.array([[0.5001, 0.4999],
                                        [0.4999, 0.5001]]))
    params = _both(np.log([0.5, 0.5]), np.log(np.full((2, 2), 0.5)),
                   log_em)
    sym = (rng.randint(0, 2, size=(L, 1)) + 1).astype(np.uint8)
    return params, sym


def _mono_gamma(jparams, sym):
    obs = track_log_likelihoods(jparams.log_em, jnp.asarray(sym))[None]
    ah, _, _ = jdp.forward_scaled(jparams.log_start, jparams.log_trans, obs)
    bh, _ = jdp.backward_scaled(jparams.log_trans, obs)
    return np.asarray(jdp.posterior_scaled(ah, bh)[0])


def _sticky(rng, S=3, V=5):
    trans = rng.dirichlet(np.ones(S), size=S) * 0.1 + np.eye(S) * 0.9
    log_em = np.zeros((S, 1, V), np.float32)
    log_em[:, 0, 1:] = np.log(rng.dirichlet(np.ones(V - 1), size=S))
    return _both(np.log(np.full(S, 1.0 / S)), np.log(trans), log_em)


def test_exact_matches_reference_adversarial(rng):
    (jp, tp), sym = _adversarial(rng, 1000)
    mono = np.argmax(_mono_gamma(jp, sym), axis=-1)
    want = jstitch.posterior_exact(jp, [sym], chunk_len=128)
    got = tstitch.posterior_exact(tp, [sym], chunk_len=128)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], mono)


def test_exact_ragged_batch_matches_reference(rng):
    jp, tp = _sticky(rng, S=2, V=4)
    syms = [(rng.randint(0, 3, size=(L, 1)) + 1).astype(np.uint8)
            for L in (701, 350, 513, 1)]
    want = jstitch.posterior_exact(jp, syms, chunk_len=100)
    got = tstitch.posterior_exact(tp, syms, chunk_len=100)
    for sym, w, g in zip(syms, want, got):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, np.argmax(_mono_gamma(jp, sym), axis=-1))


def test_exact_decoder_tolerates_empty_tables(rng):
    jp, tp = _sticky(rng, S=2, V=3)
    syms = [(rng.randint(0, 2, size=(40, 1)) + 1).astype(np.uint8),
            np.zeros((0, 1), np.uint8)]
    got = tstitch.posterior_exact(tp, syms, chunk_len=16)
    want = jstitch.posterior_exact(jp, syms, chunk_len=16)
    assert len(got[0]) == 40 and len(got[1]) == 0
    np.testing.assert_array_equal(got[0], want[0])
    assert [len(p) for p in tstitch.posterior_exact(
        tp, [np.zeros((0, 1), np.uint8)])] == [0]


def _near_tie(rng, L):
    """Sticky transitions over near-uniform emissions: each decision
    depends on evidence far beyond a small halo."""
    log_em = np.zeros((2, 1, 3), np.float32)
    log_em[:, 0, 1:] = np.log(np.array([[0.51, 0.49], [0.49, 0.51]]))
    params = _both(np.log([0.5, 0.5]),
                   np.log(np.array([[0.99, 0.01], [0.01, 0.99]])), log_em)
    sym = (rng.randint(0, 2, size=(L, 1)) + 1).astype(np.uint8)
    return params, sym


@pytest.mark.parametrize("model,halo,max_halo,fallback", [
    (_adversarial, 8, 256, False),
    (_near_tie, 4, 16, True),
])
def test_chunked_stitching_and_fallback_like_reference(rng, model, halo,
                                                       max_halo, fallback):
    """posterior_chunked takes the JAX package's retries and, where the
    boundaries never agree, its exact fallback; the paths equal the
    monolithic argmax either way."""
    (jp, tp), sym = model(rng, 800)
    kw = dict(chunk_len=100, halo=halo, max_halo=max_halo, rows_per_pass=4)
    want, jrep = jstitch.posterior_chunked(jp, [sym], **kw)
    got, trep = tstitch.posterior_chunked(tp, [sym], **kw)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert trep.boundaries_ok
    if fallback:
        assert trep.retries >= 1 and trep.final_halo == max_halo
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(
        got[0], np.argmax(_mono_gamma(jp, sym), axis=-1))


def test_chunked_multichunk_matches_reference(rng):
    """A sticky model over 2 tables of several chunks: boundaries agree
    at the first halo, and the paths equal the JAX package's and the
    exact decoder's."""
    jp, tp = _sticky(rng)
    states = np.repeat(rng.randint(0, 3, size=40), 100)
    syms = [(states[:n] + rng.randint(0, 2, size=n) + 1)
            .clip(1, 4).astype(np.uint8)[:, None] for n in (4000, 2600)]
    kw = dict(chunk_len=512, halo=64, rows_per_pass=3)
    want, jrep = jstitch.posterior_chunked(jp, syms, **kw)
    got, trep = tstitch.posterior_chunked(tp, syms, **kw)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    exact = tstitch.posterior_exact(tp, syms, chunk_len=512)
    for g, w, x in zip(got, want, exact):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, x)


def _model(pair, names, V):
    tl = TrackList()
    tl.add(Track(name="a", path="unused.bed"))
    cm = CategoryMap()
    for v in range(1, V):
        cm.get_map(str(v), update=True)
    return [cls(p, tl, {"a": cm}, names)
            for cls, p in zip((JaxHmm, PortHmm), pair)]


def test_posterior_distributions_stream_bitexact(rng):
    """--pd streaming: the port's chunk-recomputed gamma equals its own
    monolithic gamma bit for bit, and the JAX package's within 1e-5."""
    lt = np.log(np.array([[0.97, 0.02, 0.01], [0.02, 0.96, 0.02],
                          [0.01, 0.02, 0.97]]))
    log_em = np.zeros((3, 1, 5), np.float32)
    log_em[:, 0, 1:] = np.log(np.array([
        [0.7, 0.1, 0.1, 0.1], [0.1, 0.7, 0.1, 0.1], [0.1, 0.1, 0.1, 0.7],
    ]))
    pair = _both(np.log(np.full(3, 1 / 3)), lt, log_em)
    jm, tm = _model(pair, ["x", "y", "z"], 5)
    L = 1777
    sym = (rng.randint(0, 4, (L, 1)) + 1).astype(np.uint8)
    tab = TrackTable("chr1", 0, L, sym)
    got = tm.posterior_distributions([tab], chunk_len=256)[0]
    tp = pair[1]
    obs = tem.track_log_likelihoods(
        tp.log_em, torch.from_numpy(sym.astype(np.int32)))[None]
    ah, _, _ = tdp.forward_scaled(tp.log_start, tp.log_trans, obs)
    bh, _ = tdp.backward_scaled(tp.log_trans, obs)
    np.testing.assert_array_equal(
        got, tdp.posterior_scaled(ah, bh)[0].numpy())
    want = jm.posterior_distributions([tab], chunk_len=256)[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_score_matches_reference(rng):
    """MultitrackHmm.score over ragged tables (incl. empty and length 1)
    and several chunks, against the JAX package; all-empty gives 0.0;
    a mesh raises naming its slice; segment weights give the JAX
    package's posteriors."""
    jm, tm = _model(_sticky(rng), ["x", "y", "z"], 5)
    tabs = [TrackTable("chr1", 0, n, (rng.randint(0, 5, (n, 1)))
                       .astype(np.uint8)) for n in (1000, 0, 1, 613)]
    for chunk in (128, 1 << 14):
        want = jm.score(tabs, chunk_len=chunk)
        got = tm.score(tabs, chunk_len=chunk)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    empty = TrackTable("chr1", 0, 0, np.zeros((0, 1), np.uint8))
    assert tm.score([empty, empty]) == 0.0
    with pytest.raises(NotImplementedError, match="slice 6"):
        tm.score(tabs, mesh=object())
    weights = [rng.uniform(1.0, 5.0, len(t)).astype(np.float32)
               for t in tabs]
    got = tm.posterior_distributions(tabs, chunk_len=256,
                                     weight_arrays=weights)
    want = jm.posterior_distributions(tabs, chunk_len=256,
                                      weight_arrays=weights)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------
# the eval CLI against the JAX CLI
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    """A copy of tests/data with a supervised model trained by the port."""
    work = tmp_path_factory.mktemp("posterior_cli")
    for f in os.listdir(DATA):
        src = os.path.join(DATA, f)
        if os.path.isfile(src):
            shutil.copy(src, work / f)
    assert port_train.main([str(work / "tracks.xml"), str(work / "truth.bed"),
                            str(work / "m.npz"), "--supervised",
                            "--device", "cpu"]) == 0
    return work


def _run_eval(cli, work, extra, capsys):
    capsys.readouterr()
    argv = [str(work / "tracks.xml"), str(work / "m.npz"),
            str(work / "regions.bed"), *extra]
    if cli is port_eval:
        argv += ["--device", "cpu"]
    assert cli.main(argv) == 0
    return float(capsys.readouterr().out.strip())


@pytest.mark.parametrize("flags", [
    ["--exact"],
    ["--no-exact"],
    ["--exact", "--chunk", "300"],
    ["--no-exact", "--chunk", "500", "--halo", "32"],
])
def test_cli_max_posterior_matches_reference(cli_dir, capsys, flags):
    beds = {}
    scores = {}
    for name, cli in (("jax", jax_eval), ("port", port_eval)):
        out = str(cli_dir / f"{name}.bed")
        scores[name] = _run_eval(cli, cli_dir,
                                 ["--bed", out, "--maxPost", *flags], capsys)
        beds[name] = open(out, "rb").read()
    assert beds["port"] == beds["jax"] and beds["port"]
    np.testing.assert_allclose(scores["port"], scores["jax"], rtol=1e-5)


def _pd_rows(path):
    keys, vals = [], []
    for line in open(path):
        chrom, s, e, probs = line.rstrip("\n").split("\t")
        keys.append((chrom, int(s), int(e)))
        vals.append([float(p) for p in probs.split(",")])
    return keys, np.asarray(vals)


@pytest.mark.parametrize("chunk,per", [
    pytest.param("4096", None, id="4096"),
    pytest.param("700", None, id="700"),
    pytest.param("700", 1, id="700-groups-of-1"),
    pytest.param("700", 2, id="700-groups-of-2"),
])
def test_cli_pd_and_scoring_match_reference(cli_dir, capsys, monkeypatch,
                                            chunk, per):
    """--pd: the same rows, probabilities within 1e-5; scoring with no
    --bed: the JAX CLI's number within 1e-5 relative.  ``per``: the
    exact posteriors' groups cut to that many chunks (else the default
    budget's one group)."""
    if per is not None:
        monkeypatch.setattr(tstitch, "exact_group_chunks",
                            lambda B, Lc, S, tensors=2: per)
    pds, scores = {}, {}
    for name, cli in (("jax", jax_eval), ("port", port_eval)):
        out = str(cli_dir / f"{name}_pd.bed")
        _run_eval(cli, cli_dir, ["--pd", out, "--chunk", chunk], capsys)
        pds[name] = _pd_rows(out)
        scores[name] = _run_eval(cli, cli_dir, ["--chunk", chunk], capsys)
    (pk_, pv), (jk, jv) = pds["port"], pds["jax"]
    assert pk_ == jk and len(pk_) == 2400
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pv.sum(axis=1), 1.0, atol=1e-5)
    assert np.isfinite(scores["port"])
    np.testing.assert_allclose(scores["port"], scores["jax"], rtol=1e-5)
