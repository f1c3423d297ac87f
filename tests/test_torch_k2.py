"""K2, the stitched Viterbi decode, on the CPU: ``ck.viterbi_fused`` (K2's
forward in pointer mode, then X3's chase over the pointers) against the
JAX ``viterbi_fused_pallas_v4`` (interpret mode) with ragged lengths
(0, 1 and the whole row), integer tables that tie (the lowest state must
win) and each optional stream; the pointers (the identity at position 0
and past each length, and chased, the value-row backtrace's path); and
the choice of step (``ck.k2_step``: the lanes kernel to 32 states where
its ring fits, the shared kernel to K2's envelope, which it names past
its edge) with its shared memory and the card's launches faked."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.models import gauss as jgauss  # noqa: E402
from tehmm_tpu.ops import pallas_kernels as pk  # noqa: E402
from tehmm_tpu_torch.models import gauss as tgauss  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp as tdp  # noqa: E402

T, V = 5, 9                       # the decode model's tracks and symbols
EDGE = 217                        # K2's envelope's edge at T=5, V=9, G=0
VARIANTS = ["", "+w", "+g", "+wg"]
L = 40
# ragged: the whole row, 0, 1, and lengths between
LENGTHS = [L, 0, 1, 17, 2, L - 1]


def _t(a):
    return torch.from_numpy(np.array(a))


def _tables(rng, S, T_=3, V_=5, ties=False):
    """(log_start, log_trans, log_em) as float32; with ``ties`` small
    integers, so every sum is exact and equal candidates tie."""
    if ties:
        return (rng.randint(-2, 1, size=S).astype(np.float32),
                rng.randint(-3, 1, size=(S, S)).astype(np.float32),
                rng.randint(-2, 1, size=(S, T_, V_)).astype(np.float32))
    start = np.log(rng.dirichlet(np.ones(S))).astype(np.float32)
    trans = np.log(rng.dirichlet(np.ones(S), size=S)).astype(np.float32)
    log_em = np.log(rng.dirichlet(np.ones(V_), size=(S, T_))).astype(
        np.float32)
    return start, trans, log_em


def _streams(rng, S, variant, B, G=2):
    """The JAX and the port's keyword arguments of one stream variant:
    weights in [1, 8], G gaussian tracks with 10% of the values
    missing."""
    j, t = {}, {}
    if "w" in variant:
        w = rng.uniform(1.0, 8.0, size=(B, L)).astype(np.float32)
        j["obs_weights"], t["obs_weights"] = jnp.asarray(w), _t(w)
    if "g" in variant:
        mu = rng.randn(S, G).astype(np.float32)
        log_var = (rng.randn(S, G) * 0.3).astype(np.float32)
        v = rng.randn(B, L, G).astype(np.float32)
        v[rng.rand(B, L, G) < 0.1] = np.nan
        j["gauss_params"] = jgauss.GaussParams(jnp.asarray(mu),
                                               jnp.asarray(log_var))
        j["gauss_values"] = jnp.asarray(v)
        t["gauss_params"] = tgauss.from_numpy(mu, log_var, "cpu")
        t["gauss_values"] = _t(v)
    return j, t


def _against_pallas(tables, sym, lengths, j_kw=None, t_kw=None):
    want_p, want_s = pk.viterbi_fused_pallas_v4(
        *(jnp.asarray(x) for x in tables), jnp.asarray(sym),
        jnp.asarray(lengths), **(j_kw or {}))
    got_p, got_s = ck.viterbi_fused(*(_t(x) for x in tables), _t(sym),
                                    _t(lengths), **(t_kw or {}))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)
    return got_p


@pytest.fixture(autouse=True)
def _zero_counts():
    ck.reset_launch_counts()
    yield


def _no_launches():
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES


# ---------------------------------------------------------------------
# the decode against the JAX package
# ---------------------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_fused_matches_pallas_v4(rng, ties):
    """Paths equal to ``viterbi_fused_pallas_v4``'s (the end state held
    past each length, 0 for the zero-length row), scores within 1e-5; on
    integer tables the ties go to the lowest state, as the JAX kernel's
    first-hit argmax sends them."""
    S = 6
    tables = _tables(rng, S, ties=ties)
    sym = rng.randint(0, 5, size=(len(LENGTHS), L, 3)).astype(np.int32)
    lengths = np.asarray(LENGTHS, np.int32)
    path = _against_pallas(tables, sym, lengths)
    assert (path[1] == 0).all()
    for r, n in enumerate(LENGTHS):
        if n:
            assert (path[r, n:] == path[r, n - 1]).all()
    _no_launches()


@pytest.mark.parametrize("variant", ["+w", "+g", "+wg"])
def test_fused_streams_match_pallas_v4(rng, variant):
    S = 5
    tables = _tables(rng, S)
    B = len(LENGTHS)
    sym = rng.randint(0, 5, size=(B, L, 3)).astype(np.int32)
    j_kw, t_kw = _streams(rng, S, variant, B)
    _against_pallas(tables, sym, np.asarray(LENGTHS, np.int32), j_kw, t_kw)
    _no_launches()


# ---------------------------------------------------------------------
# the pointers
# ---------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_pointers_are_the_value_rows_backtrace(rng, ties, variant):
    """``viterbi_fwd_pointers``: the identity at position 0 and at and
    past each length; ``last`` and ``dm`` are ``viterbi_fwd``'s last row
    and normalizers; chased from the last row's first-hit argmax, the
    pointers give the value-row backtrace's path (``dp.
    viterbi_backtrace_chunk`` from row 0), and ``viterbi_fused`` that
    path with its score."""
    S = 7
    tables = [_t(x) for x in _tables(rng, S, ties=ties)]
    B = len(LENGTHS)
    sym = _t(rng.randint(0, 5, size=(B, L, 3)).astype(np.int32))
    lens = _t(np.asarray(LENGTHS, np.int32))
    _, kw = _streams(rng, S, variant, B)
    ptrs, last, dm = ck.viterbi_fwd_pointers(*tables, sym, lens, **kw)
    v, want_dm = ck.viterbi_fwd(*tables, sym, lens, **kw)
    assert ptrs.dtype == torch.uint8 and ptrs.shape == (B, L, S)
    assert torch.equal(last, v[:, -1]) and torch.equal(dm, want_dm)
    ident = torch.arange(S, dtype=torch.uint8)
    for r, n in enumerate(LENGTHS):
        for t in [0] + list(range(n, L)):
            assert torch.equal(ptrs[r, t], ident), (r, t)

    end = torch.argmax(last, dim=-1).to(torch.int32)
    chased = ck.chunk_chase(ptrs, end, lens)
    body, first = tdp.viterbi_backtrace_chunk(
        tables[1], v[:, 1:].contiguous(), v[:, 0].contiguous(), end,
        torch.clamp(lens - 1, min=0).to(torch.int32))
    want = torch.cat([first[:, None], body], dim=1)
    nonempty = (lens > 0)[:, None]
    assert torch.equal(torch.where(nonempty, chased, 0),
                       torch.where(nonempty, want, 0))
    path, score = ck.viterbi_fused(*tables, sym, lens, **kw)
    assert torch.equal(path, torch.where(nonempty, want, 0))
    assert torch.equal(score, torch.where(
        lens > 0, last.amax(dim=-1) + dm.sum(dim=1), 0.0))
    _no_launches()


# ---------------------------------------------------------------------
# the step, by states; launches faked
# ---------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 10, 16, 17, 32, 33, EDGE, EDGE + 1])
def test_k2_step_by_states(S):
    if S > EDGE:
        assert not ck.k2_fits(S, T, V)
        with pytest.raises(NotImplementedError,
                           match="K2/K3 beyond the shared-memory "
                                 "envelope"):
            ck.k2_step(S, T, V)
        return
    assert ck.k2_fits(S, T, V)
    assert ck.k2_step(S, T, V) == \
        ("lanes" if S <= ck.K2_LANES_MAX_STATES else "shared")


def test_k2_step_where_the_ring_does_not_fit(monkeypatch):
    """Inside K2's envelope at 2 states but with 120 tracks of 145
    symbols, the lanes kernel's ring (a half of 32 positions' symbols a
    slot, two slots a warp) would not fit beside log_em: the shared
    step.  With the constant at 0 every model takes the shared step."""
    assert ck.k2_fits(2, 120, 145)
    assert ck.k2_step(2, 120, 145) == "shared"
    assert ck.k2_step(2, 5, 145) == "lanes"
    assert ck.k2_step(32, T, V, 3) == "lanes"
    monkeypatch.setattr(ck, "K2_LANES_MAX_STATES", 0)
    assert ck.k2_step(10, T, V) == "shared"


@pytest.mark.parametrize("S,T_,V_,G,floats", [
    # log_em + 3SG, then 4 warps x (2 slots x 32 x (T + 1 + G) + 32 S)
    (10, 5, 9, 0, 450 + 4 * (2 * 32 * 6 + 320)),
    (10, 5, 9, 2, 510 + 4 * (2 * 32 * 8 + 320)),
    (1, 1, 2, 0, 2 + 4 * (2 * 32 * 2 + 32)),
    (32, 5, 9, 1, 32 * 45 + 96 + 4 * (2 * 32 * 7 + 1024)),
])
def test_k2_lanes_smem_floats(S, T_, V_, G, floats):
    """The lanes forward's shared memory: the tables, then per warp the
    ring's two slots (symbols, a weight and the gaussian values a
    position) and a half's obs (the card's tests hold it to the
    library's own)."""
    assert ck._k2_lanes_smem_floats(S, T_, V_, G) == floats


def _fake_card(monkeypatch):
    launched = []
    monkeypatch.setattr(ck, "_device_kind", lambda dev: "cuda")
    # each launch's counter and entry
    monkeypatch.setattr(ck, "_launch_streaming",
                        lambda name, entry, args, dev: launched.append(
                            (name, entry)))
    return launched


def _card_case(rng, S, variant):
    tables = [_t(x) for x in _tables(rng, S, T, V)]
    B = 3
    sym = _t(rng.randint(0, V, size=(B, L, T)).astype(np.int32))
    lens = _t(np.asarray([L, 0, 2], np.int32))
    _, kw = _streams(rng, S, variant, B, G=1)
    return (*tables, sym, lens), kw


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("S", [1, 10, 32, 33, 100])
def test_k2_route_launches(rng, monkeypatch, S, variant):
    """On the card each mode of K2's forward launches the kernel of
    ``k2_step`` once, under the counter of its step and stream variant
    (``viterbi_fwd_lanes`` to 32 states, ``viterbi_fwd`` beyond), and
    ``viterbi_fused`` is the pointer mode then the chase, with no
    value-row backtrace; with the constant at 0, the shared kernel."""
    launched = _fake_card(monkeypatch)
    args, kw = _card_case(rng, S, variant)
    step = ck.k2_step(S, T, V, 1 if "g" in variant else 0)
    assert step == ("lanes" if S <= 32 else "shared")
    counter = {"lanes": "viterbi_fwd_lanes", "shared": "viterbi_fwd"}
    values = {"lanes": "tehmm_viterbi_fwd_lanes",
              "shared": "tehmm_viterbi_fwd"}
    ptrs = {"lanes": "tehmm_viterbi_fwd_ptrs_lanes",
            "shared": "tehmm_viterbi_fwd_ptrs"}
    ck.viterbi_fwd(*args, **kw)
    ck.viterbi_fwd_pointers(*args, **kw)
    assert launched == [(counter[step] + variant, values[step]),
                        (counter[step] + variant, ptrs[step])]
    launched.clear()
    ck.viterbi_fused(*args, **kw)
    assert launched == [(counter[step] + variant, ptrs[step]),
                        ("chunk_chase", "tehmm_chunk_chase")]
    launched.clear()
    monkeypatch.setattr(ck, "K2_LANES_MAX_STATES", 0)
    ck.viterbi_fwd_pointers(*args, **kw)
    assert launched == [("viterbi_fwd" + variant, ptrs["shared"])]
    assert all(k + v in ck.LAUNCHES for k in counter.values()
               for v in VARIANTS)


def test_k2_raises_past_its_envelope(rng, monkeypatch):
    """Past K2's envelope both modes raise naming its item, before any
    launch (the stitched decoder's route takes K5 there)."""
    launched = _fake_card(monkeypatch)
    args, kw = _card_case(rng, EDGE + 1, "")
    for fn in (ck.viterbi_fwd, ck.viterbi_fwd_pointers, ck.viterbi_fused):
        with pytest.raises(NotImplementedError, match="K2/K3 beyond"):
            fn(*args, **kw)
    assert launched == []
