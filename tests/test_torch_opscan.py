"""The piece-operator scan (``dp.forward_loglik_pieces``, the plain
version of the card's ``fwd_piece_ops`` and ``fwd_piece_compose``; the
route of ``MultitrackHmm.score``) against the JAX package: a piece's
operator against ``parallel/seqpar._chunk_operator``, the carry and the
summed increments against ``ops/dp.forward_final`` and the port's
float64 chain, chained chunks against one chunk, the score with the
pieces in place of the chain, and ``ck.forward_loglik``'s choice of
kernels (the launches faked: no card here).

Limits (derived in PERF.md):
  * carry: against the float64 chain within X1's F3 limit, 1e-5 plus 4
    float32 ulps of the largest finite |obs| (each step rounds obs +
    log(sum) and its max to half an ulp of |obs|; the last piece's rows
    and the one composition step that makes the carry are such steps);
    against the JAX float32 chain within twice that (both sides' error);
  * summed increments: within 1e-6 relative and 1e-6 absolute of the
    float64 chain, X1's own limit (the pieces regroup the same
    increments, and sum them in float64); 2e-6 of the JAX chain;
  * a piece's operator log M[i, j] = log probs[i, j] + n_i against
    ``_chunk_operator`` on finite entries: the F3 limit plus PIECE
    float32 ulps of |entry| (``_chunk_operator`` keeps the operator
    unnormalised, so each of its PIECE steps rounds the entry to about
    an ulp of its size).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.io.category import CategoryMap  # noqa: E402
from tehmm_tpu.io.trackdata import TrackTable  # noqa: E402
from tehmm_tpu.io.trackxml import Track, TrackList  # noqa: E402
from tehmm_tpu.models.hmm import MultitrackHmm as JaxHmm  # noqa: E402
from tehmm_tpu.models.params import HmmParams  # noqa: E402
from tehmm_tpu.ops import dp as jdp  # noqa: E402
from tehmm_tpu.parallel.seqpar import _chunk_operator  # noqa: E402
from tehmm_tpu_torch.models.hmm import MultitrackHmm as PortHmm  # noqa: E402
from tehmm_tpu_torch.models.params import from_numpy  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp as tdp  # noqa: E402
from tehmm_tpu_torch.utils.common import LOG_ZERO  # noqa: E402

P = tdp.PIECE
F64 = torch.float64
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _nothing_launches():
    ck.reset_launch_counts()
    yield
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(rng, make_hmm, S, Lc, lengths, zero_frac=0.0,
            impossible=False):
    """log_trans, obs [B, Lc, S], a carry (max 0) and int32 lengths.
    ``impossible``: a symbol no state emits in row 0 at position P + 3
    (LOG_ZERO for every state) and one that half the states cannot emit
    in row 3 at position 5."""
    _ls, lt, _ = make_hmm(S, 2, 4, zero_trans_frac=zero_frac)
    B = len(lengths)
    obs = (rng.randn(B, Lc, S) * 3.0 - 4.0).astype(np.float32)
    if impossible:
        obs[0, P + 3, :] = LOG_ZERO
        obs[3, 5, : max(1, S // 2)] = LOG_ZERO
    init = rng.randn(B, S).astype(np.float32)
    init -= init.max(axis=-1, keepdims=True)
    return (lt.astype(np.float32), obs, init,
            np.minimum(np.asarray(lengths), Lc).astype(np.int32))


def _f3(obs):
    finite = np.abs(obs[np.abs(obs) < 1e29])
    return 1e-5 + 4 * EPS32 * float(finite.max())


def _held(got, want, lim, what):
    """got within ``lim`` of want where want is finite; both at LOG_ZERO
    elsewhere."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    finite = want > -1e29
    assert (got[~finite] < -1e29).all(), what
    err = np.abs(got - want)[finite]
    assert err.size == 0 or err.max() <= lim, \
        f"{what}: max err {err.max():.3g} > {lim:.3g}"


# (S, Lc, zero_frac, impossible); each row set has lengths Lc, 0, 1,
# P - 1, P, P + 1 and one that ends mid-piece, capped at Lc
CASES = [
    (1, 3 * P + 17, 0.0, False),
    (2, 3 * P + 17, 0.0, False),
    (10, 3 * P + 17, 0.0, False),
    (10, 2 * P, 0.0, False),                 # Lc a multiple of P
    (10, 3 * P + 17, 0.5, False),            # zero transitions
    (10, 3 * P + 17, 0.0, True),             # impossible symbols
    (33, 2 * P + 40, 0.3, False),
    (64, P + 9, 0.0, True),
]


def _lengths(Lc):
    return [Lc, 0, 1, P - 1, P, P + 1, P + P // 2 + 7]


@pytest.mark.parametrize("S,Lc,zero_frac,impossible", CASES)
def test_pieces_match_the_chain(rng, make_hmm, S, Lc, zero_frac,
                                impossible):
    """Carry and summed increments of the pieces against the JAX
    package's forward_final and the port's float64 chain."""
    lt, obs, init, lens = _inputs(rng, make_hmm, S, Lc, _lengths(Lc),
                                  zero_frac, impossible)
    got_c, got_dm = tdp.forward_loglik_pieces(_t(lt), _t(obs), _t(init),
                                              _t(lens))
    ref_c, ref_dm = tdp.forward_final(_t(lt), _t(obs), _t(init), _t(lens),
                                      dtype=F64)
    lim = _f3(obs)
    # a position no state emits adds LOG_ZERO, which float64 does not
    # hold as float32 does (-1e30 against float32's -1.0000000150e30, so
    # its chain restarts a step later): those rows are held to the
    # float32 chains alone
    dead = (ref_dm < -1e29).numpy()
    _held(got_c[~dead], ref_c[~dead], lim, "carry vs float64 chain")
    np.testing.assert_allclose(got_dm.double()[~dead], ref_dm[~dead],
                               rtol=1e-6, atol=1e-6)
    jax_c, jax_dm = jdp.forward_final(jnp.asarray(lt), jnp.asarray(obs),
                                      jnp.asarray(init), jnp.asarray(lens))
    _held(got_c, np.asarray(jax_c), 2 * lim, "carry vs JAX chain")
    np.testing.assert_allclose(got_dm.numpy(), np.asarray(jax_dm),
                               rtol=2e-6, atol=2e-6)
    assert (got_dm.numpy()[dead] < -1e29).all()
    # a zero-length row passes its carry through bit for bit
    assert torch.equal(got_c[1], _t(init)[1]) and float(got_dm[1]) == 0.0


@pytest.mark.parametrize("S,Lc,zero_frac,impossible", CASES)
def test_piece_operator_matches_seqpar(rng, make_hmm, S, Lc, zero_frac,
                                       impossible):
    """Every live piece's operator from phase A against the JAX
    package's sequential operator composition of that piece."""
    lt, obs, init, lens = _inputs(rng, make_hmm, S, Lc, _lengths(Lc),
                                  zero_frac, impossible)
    probs, n = tdp.piece_operators(_t(lt), _t(obs), _t(lens))
    B, n_p = probs.shape[:2]
    assert n_p == -(-Lc // P) and n.dtype == F64
    log_m = torch.log(probs.double()) + n[..., None]
    lim = _f3(obs)
    checked = 0
    for b in range(B):
        for p in range(n_p):
            lo = p * P
            if lo >= lens[b]:
                continue
            piece = np.zeros((P, S), np.float32)
            piece[: min(P, Lc - lo)] = obs[b, lo : lo + P]
            valid = lo + np.arange(P) < lens[b]
            want = np.asarray(_chunk_operator(
                jnp.asarray(lt), jnp.asarray(piece), jnp.asarray(valid)),
                np.float64)
            got = log_m[b, p].numpy()
            finite = (want > -1e29) & (got > -1e29)
            err = np.abs(got - want)[finite]
            tol = lim + P * EPS32 * np.abs(want)[finite]
            assert (err <= tol).all(), \
                f"row {b} piece {p}: max err/limit {(err / tol).max():.3g}"
            checked += 1
    assert checked >= B


@pytest.mark.parametrize("cuts", [(0, P, 3 * P, 4 * P + 50),
                                  (0, 100, 301, 4 * P + 50),
                                  (0, 1, 2, 4 * P + 50)])
def test_chained_chunks_match_one_chunk(rng, make_hmm, cuts):
    """A row cut into chunks, each chunk's carry fed to the next, against
    one chunk: where every cut is a multiple of PIECE the pieces are the
    same and the carry is the same bits; anywhere, both within the
    limits of the float64 chain."""
    S, Lc = 10, cuts[-1]
    lt, obs, init, lens = _inputs(rng, make_hmm, S, Lc,
                                  [Lc, Lc - 3, 2 * P + 5, 0])
    lt, tobs, tinit = _t(lt), _t(obs), _t(init)
    one_c, one_dm = tdp.forward_loglik_pieces(lt, tobs, tinit, _t(lens))
    carry, total = tinit, torch.zeros(len(lens), dtype=torch.float32)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        part = _t(np.clip(lens - lo, 0, hi - lo).astype(np.int32))
        carry, dm = tdp.forward_loglik_pieces(
            lt, tobs[:, lo:hi].contiguous(), carry, part)
        total = total + dm
    if all(c % P == 0 for c in cuts[:-1]):
        assert torch.equal(carry, one_c)
    ref_c, ref_dm = tdp.forward_final(lt, tobs, tinit, _t(lens), dtype=F64)
    for c, d in ((one_c, one_dm), (carry, total)):
        _held(c, ref_c, _f3(obs), "carry vs float64 chain")
        np.testing.assert_allclose(d.double(), ref_dm, rtol=1e-6,
                                   atol=1e-6)


def _models(rng, S=3, V=5):
    """A sticky model as the JAX package's and the port's MultitrackHmm
    (as ``tests/test_torch_posterior.py`` builds them)."""
    trans = rng.dirichlet(np.ones(S), size=S) * 0.1 + np.eye(S) * 0.9
    log_em = np.zeros((S, 1, V), np.float32)
    log_em[:, 0, 1:] = np.log(rng.dirichlet(np.ones(V - 1), size=S))
    tables = [np.asarray(x, np.float32)
              for x in (np.log(np.full(S, 1.0 / S)), np.log(trans), log_em)]
    tl = TrackList()
    tl.add(Track(name="a", path="unused.bed"))
    cm = CategoryMap()
    for v in range(1, V):
        cm.get_map(str(v), update=True)
    names = [f"s{i}" for i in range(S)]
    return (JaxHmm(HmmParams(*(jnp.asarray(x) for x in tables)), tl,
                   {"a": cm}, names),
            PortHmm(from_numpy(*tables, "cpu"), tl, {"a": cm}, names))


@pytest.mark.parametrize("chunk", [P, 300, 1 << 14])
def test_score_through_the_pieces_matches_reference(rng, monkeypatch,
                                                    chunk):
    """MultitrackHmm.score with the pieces' plain version in place of the
    chain (the card's route), against the JAX package's score on ragged
    tables (incl. empty and length 1) and several chunks."""
    jm, tm = _models(rng)
    tabs = [TrackTable("chr1", 0, n, rng.randint(0, 5, (n, 1))
                       .astype(np.uint8)) for n in (1000, 0, 1, 613)]
    calls = []

    def pieces(lt, obs, a_hat, lens):
        calls.append(obs.shape)
        return tdp.forward_loglik_pieces(lt, obs, a_hat, lens)

    monkeypatch.setattr(ck, "forward_loglik", pieces)
    got = tm.score(tabs, chunk_len=chunk)
    assert calls and all(s[0] == len(tabs) for s in calls)
    np.testing.assert_allclose(got, jm.score(tabs, chunk_len=chunk),
                               rtol=1e-6)


def test_cpu_score_stays_the_chain(rng, make_hmm):
    """On CPU tensors ``ck.forward_loglik`` is ``dp.forward_final``, bit
    for bit, and the piece wrappers are their plain versions."""
    lt, obs, init, lens = _inputs(rng, make_hmm, 10, 3 * P + 17,
                                  _lengths(3 * P + 17))
    args = (_t(lt), _t(obs), _t(init), _t(lens))
    for got, want in zip(ck.forward_loglik(*args), tdp.forward_final(*args)):
        assert torch.equal(got, want)
    probs, n = ck.piece_operators(args[0], args[1], args[3])
    want_p, want_n = tdp.piece_operators(args[0], args[1], args[3])
    assert torch.equal(probs, want_p) and torch.equal(n, want_n)
    for got, want in zip(ck.compose_pieces(probs, n, args[2], args[3]),
                         tdp.compose_pieces(probs, n, args[2], args[3])):
        assert torch.equal(got, want)


def _fake_card(monkeypatch):
    launched = []
    monkeypatch.setattr(ck, "_device_kind", lambda dev: "cuda")
    monkeypatch.setattr(ck, "_launch_streaming",
                        lambda name, entry, args, dev:
                        launched.append((name, entry, args[-4])))
    return launched


@pytest.mark.parametrize("S", [1, 10, 64, ck.PIECE_SCAN_MAX_STATES,
                               ck.PIECE_SCAN_MAX_STATES + 1, 239, 240,
                               1024])
def test_forward_loglik_takes_the_pieces_to_their_crossover(monkeypatch, S):
    """On the card ``forward_loglik`` launches fwd_piece_ops then
    fwd_piece_compose to ``PIECE_SCAN_MAX_STATES``, and beyond it
    ``forward_final``'s kernels: X1's chain where ``sweep_fits``, the
    tile's carry mode past it (two rows: the rows' cap is never met)."""
    launched = _fake_card(monkeypatch)
    B, L = 2, 3 * P + 1
    carry, dm = ck.forward_loglik(
        torch.zeros((S, S)), torch.zeros((B, L, S)), torch.zeros((B, S)),
        torch.full((B,), L, dtype=torch.int32))
    assert carry.shape == (B, S) and dm.shape == (B,)
    assert dm.dtype == torch.float32
    if S <= ck.PIECE_SCAN_MAX_STATES:
        assert launched == [("fwd_piece_ops", "tehmm_fwd_piece_ops", B),
                            ("fwd_piece_compose", "tehmm_fwd_piece_compose",
                             B)]
    elif ck.sweep_fits(S):
        assert [x[:2] for x in launched] == [("fwd_chunk",
                                              "tehmm_x1_sweep_smem")]
    else:   # past 256 states on the cluster tile, to 256 the rows kernel
        assert [x[:2] for x in launched] == [
            ("fwd_chunk_cluster" if S > 256 else "fwd_chunk_rows",
             "tehmm_fwd_chunk_tile")]


@pytest.mark.parametrize("S,rows", [
    (s, r + extra) for s, r in ck.PIECE_SCAN_MAX_ROWS for extra in (0, 1)]
    + [(11, 32), (11, 33), (65, 17), (129, 5)])
def test_forward_loglik_caps_the_pieces_rows(monkeypatch, S, rows):
    """At each S the pieces take a chunk of at most the rows of
    ``PIECE_SCAN_MAX_ROWS`` at the first entry at or above S (where they
    still beat the chain), the chain a chunk of more; by shape alone."""
    launched = _fake_card(monkeypatch)
    L = P + 1
    cap = next(r for s, r in ck.PIECE_SCAN_MAX_ROWS if S <= s)
    ck.forward_loglik(
        torch.zeros((S, S)), torch.zeros((rows, L, S)),
        torch.zeros((rows, S)), torch.full((rows,), L, dtype=torch.int32))
    assert ck.piece_scan_route(rows, S) == (rows <= cap)
    if rows <= cap:
        assert [x[0] for x in launched] == ["fwd_piece_ops",
                                            "fwd_piece_compose"]
    else:
        assert [x[0] for x in launched] == ["fwd_chunk"]


def test_forward_loglik_groups_rows_under_the_byte_cap(monkeypatch):
    """Rows go through the two kernels in groups whose operators stay
    under ``_PIECE_OPS_BYTES``; an empty chunk or batch launches
    nothing and passes the carry through."""
    launched = _fake_card(monkeypatch)
    S, B, L = 10, 7, 2 * P
    per_row = 2 * S * (4 * S + 8)                 # n_pieces = 2
    monkeypatch.setattr(ck, "_PIECE_OPS_BYTES", 3 * per_row)
    carry, dm = ck.forward_loglik(
        torch.zeros((S, S)), torch.zeros((B, L, S)), torch.zeros((B, S)),
        torch.full((B,), L, dtype=torch.int32))
    assert carry.shape == (B, S) and dm.shape == (B,)
    assert [(name, rows) for name, _e, rows in launched] == [
        ("fwd_piece_ops", 3), ("fwd_piece_compose", 3),
        ("fwd_piece_ops", 3), ("fwd_piece_compose", 3),
        ("fwd_piece_ops", 1), ("fwd_piece_compose", 1)]
    launched.clear()
    init = torch.randn((B, S))
    carry, dm = ck.forward_loglik(
        torch.zeros((S, S)), torch.zeros((B, 0, S)), init,
        torch.zeros((B,), dtype=torch.int32))
    assert launched == [] and torch.equal(carry, init)
    assert torch.equal(dm, torch.zeros(B))


def test_piece_wrappers_check_their_inputs():
    S, B, L = 4, 2, 5
    lt, obs = torch.zeros((S, S)), torch.zeros((B, L, S))
    lens = torch.full((B,), L, dtype=torch.int32)
    with pytest.raises(TypeError, match="lengths"):
        ck.piece_operators(lt, obs, lens.long())
    probs, n = ck.piece_operators(lt, obs, lens)
    with pytest.raises(TypeError, match="log_scale"):
        ck.compose_pieces(probs, n.float(), torch.zeros((B, S)), lens)
    with pytest.raises(ValueError, match="a_hat_init"):
        ck.compose_pieces(probs, n, torch.zeros((B, S + 1)), lens)


def test_time_score_rows(capsys):
    """``tools.time_score``: the device line, then one row a (S, rows)
    point with both times of the chain and of the pieces (the plain
    versions here) and the route ``forward_loglik`` takes there.  Which
    points print follows the tool's rule applied to their own printed
    speedups (the times, and so the speedups, vary with the host's
    load): every S starts at rows = 1, and the next row count of that S
    appears exactly when the point before it had speedup >= 0.5."""
    from tehmm_tpu_torch.tools import time_score

    states, grid = (3, 5), (1, 2)
    assert time_score.main(["--states", "3,5", "--rows", "1,2",
                            "--length", str(P + 3), "--reps", "1",
                            "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# device: cpu"
    rows = [json.loads(line) for line in lines[1:]]
    assert all(r["L"] == P + 3 for r in rows)
    assert [r["S"] for r in rows] == sorted(r["S"] for r in rows)
    for S in states:
        points = [r for r in rows if r["S"] == S]
        assert [r["rows"] for r in points] == list(grid[:len(points)])
        assert points, f"S={S} printed no point at rows = 1"
        for i, r in enumerate(points):
            goes_on = i + 1 < len(grid) and r["speedup"] >= 0.5
            assert (i + 1 < len(points)) == goes_on, (S, r)
    for r in rows:
        assert len(r["chain_ms"]) == len(r["pieces_ms"]) == 2
        assert min(r["chain_ms"] + r["pieces_ms"]) > 0
        assert r["speedup"] == pytest.approx(
            min(r["chain_ms"]) / min(r["pieces_ms"]))
        assert r["route"] == ("pieces" if ck.piece_scan_route(r["rows"],
                                                              r["S"])
                              else "chain")


def test_time_score_ends_an_s_where_the_pieces_lose(capsys, monkeypatch):
    """Past a point where the pieces took more than twice the chain's
    time, the larger row counts at that S are skipped."""
    from tehmm_tpu_torch.tools import time_score

    def point(S, rows, length, device, reps):
        return {"S": S, "rows": rows, "speedup": 4.0 / rows}

    monkeypatch.setattr(time_score, "time_point", point)
    assert time_score.main(["--states", "3,5", "--rows", "1,4,9,16",
                            "--device", "cpu"]) == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.splitlines()[1:]]
    assert [(r["S"], r["rows"]) for r in rows] == [
        (3, 1), (3, 4), (3, 9), (5, 1), (5, 4), (5, 9)]
