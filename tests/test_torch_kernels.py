"""The CUDA kernels' wrappers on the CPU: their plain versions against
the Pallas kernels they replace (run in interpret mode, as
tests/test_pallas.py runs them), and the CPU dispatch rule — a CPU
tensor takes the plain version and launches nothing."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.models.emission import track_log_likelihoods  # noqa: E402
from tehmm_tpu.ops import pallas_kernels as pk  # noqa: E402
from tehmm_tpu_torch.models import emission as tem  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp as tdp  # noqa: E402

LENGTHS = [37, 28, 1, 0]


def _setup(rng, make_hmm, S=5, T=3, V=6, L=37, lengths=LENGTHS):
    ls, lt, lem = (x.astype(np.float32) for x in make_hmm(S, T, V))
    sym = rng.randint(0, V, size=(len(lengths), L, T)).astype(np.int32)
    return ls, lt, lem, sym, np.asarray(lengths, np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def _zero_counts():
    ck.reset_launch_counts()
    yield
    # nothing on the CPU may launch (or build) a kernel
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES


@pytest.mark.parametrize("S", [5, 10])
def test_fused_plain_matches_pallas_v4(rng, make_hmm, S):
    """K2: paths equal to viterbi_fused_pallas_v4, score within 1e-5."""
    ls, lt, lem, sym, lens = _setup(rng, make_hmm, S=S)
    want_p, want_s = pk.viterbi_fused_pallas_v4(
        jnp.asarray(ls), jnp.asarray(lt), jnp.asarray(lem),
        jnp.asarray(sym), jnp.asarray(lens),
    )
    got_p, got_s = ck.viterbi_fused(_t(ls), _t(lt), _t(lem), _t(sym),
                                    _t(lens))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)


def test_fwd_plain_values_match_pallas_rows(rng, make_hmm):
    """K2 forward's value rows and normalizers equal the Pallas
    streaming kernel's (same recurrence from start, same masking) on
    the same obs, within 1e-5."""
    ls, lt, lem, sym, lens = _setup(rng, make_hmm)
    obs = track_log_likelihoods(jnp.asarray(lem), jnp.asarray(sym))
    init = jnp.broadcast_to(jnp.asarray(ls)[None], (len(lens), len(ls)))
    want_v, want_dm = pk._viterbi_values_v3(
        init, jnp.asarray(lt), obs, jnp.asarray(lens), carry_mode=False
    )
    got_v, got_dm = ck.viterbi_fwd(_t(ls), _t(lt), _t(lem), _t(sym),
                                   _t(lens))
    # zero-length rows: both carry an inert zero row
    np.testing.assert_allclose(
        got_v.numpy(), np.moveaxis(np.asarray(want_v), 0, 1),
        rtol=0, atol=1e-5,
    )
    np.testing.assert_allclose(
        got_dm.numpy(), np.asarray(want_dm).T, rtol=0, atol=1e-5
    )


def test_chunk_values_plain_matches_pallas(rng, make_hmm):
    """K3: viterbi_chunk_values equals viterbi_chunk_values_pallas; the
    carry mode is its last row, and the checkpoint mode its rows at the
    end of every chunk."""
    _, lt, lem, sym, lens = _setup(rng, make_hmm, L=23,
                                   lengths=[23, 11, 23])
    obs = np.asarray(track_log_likelihoods(jnp.asarray(lem),
                                           jnp.asarray(sym)))
    init = np.random.RandomState(3).randn(3, lt.shape[0]) \
        .astype(np.float32)
    want = pk.viterbi_chunk_values_pallas(
        jnp.asarray(lt), jnp.asarray(obs), jnp.asarray(init),
        jnp.asarray(lens),
    )
    got = ck.viterbi_chunk_values(_t(lt), _t(obs), _t(init), _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    carry = ck.viterbi_carry(_t(lt), _t(obs), _t(init), _t(lens))
    np.testing.assert_array_equal(carry.numpy(), got.numpy()[:, -1])
    L = obs.shape[1]
    for chunk in (1, 5, 23, 30):
        ckpts = ck.viterbi_checkpoints(_t(lt), _t(obs), _t(init), _t(lens),
                                       chunk)
        ends = [min(c + chunk, L) - 1 for c in range(0, L, chunk)]
        np.testing.assert_allclose(ckpts.numpy(), np.asarray(want)[:, ends],
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(ckpts.numpy(), got.numpy()[:, ends])


def test_chunk_values_plain_matches_pallas_past_256_states(rng, make_hmm):
    """K3 at S = 260, where the card runs K5's cluster tile in carry mode:
    the value rows equal viterbi_chunk_values_pallas's (ragged, a
    zero-length row), the carry mode is their last row and the checkpoint
    mode their rows at the end of every chunk."""
    _, lt, lem, sym, lens = _setup(rng, make_hmm, S=260, T=1, L=7,
                                   lengths=[7, 4, 1, 0])
    obs = np.asarray(track_log_likelihoods(jnp.asarray(lem),
                                           jnp.asarray(sym)))
    init = np.random.RandomState(4).randn(4, 260).astype(np.float32)
    init -= init.max(axis=-1, keepdims=True)
    want = np.asarray(pk.viterbi_chunk_values_pallas(
        jnp.asarray(lt), jnp.asarray(obs), jnp.asarray(init),
        jnp.asarray(lens),
    ))
    args = (_t(lt), _t(obs), _t(init), _t(lens))
    got = ck.viterbi_chunk_values(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(ck.viterbi_carry(*args), got[:, -1])
    ckpts = ck.viterbi_checkpoints(*args, 3)
    np.testing.assert_array_equal(ckpts.numpy(), got.numpy()[:, [2, 5, 6]])


def test_cpu_tensors_take_the_plain_versions(rng, make_hmm):
    """Each wrapper on CPU tensors returns exactly its plain version and
    builds nothing."""
    ls, lt, lem, sym, lens = _setup(rng, make_hmm)
    args = (_t(ls), _t(lt), _t(lem), _t(sym), _t(lens))
    v, dm = ck.viterbi_fwd(*args)
    pv, pdm = ck.viterbi_fwd_plain(*args)
    assert torch.equal(v, pv) and torch.equal(dm, pdm)

    end = torch.argmax(v[:, -1], dim=-1).to(torch.int32)
    got = ck.viterbi_backtrace(_t(lt), v[:, 1:], v[:, 0], end,
                               torch.clamp(_t(lens) - 1, min=0))
    want = tdp.viterbi_backtrace_chunk(
        _t(lt), v[:, 1:].contiguous(), v[:, 0].contiguous(), end,
        torch.clamp(_t(lens) - 1, min=0),
    )
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    obs = tem.track_log_likelihoods(_t(lem), _t(sym))
    init = torch.zeros((len(lens), len(ls)))
    assert torch.equal(
        ck.viterbi_chunk_values(_t(lt), obs, init, _t(lens)),
        tdp.viterbi_chunk_values(_t(lt), obs, init, _t(lens)),
    )
    assert torch.equal(
        ck.viterbi_carry(_t(lt), obs, init, _t(lens)),
        tdp.viterbi_carry(_t(lt), obs, init, _t(lens)),
    )
    # the fused decode on CPU equals dp.viterbi on the port's own obs
    path, score = ck.viterbi_fused(*args)
    want_p, want_s = tdp.viterbi(_t(ls), _t(lt), obs, _t(lens))
    assert torch.equal(path, want_p)
    np.testing.assert_allclose(score.numpy(), want_s.numpy(), rtol=1e-6)
    assert ck._lib is None


def test_wrappers_check_their_arguments(rng, make_hmm):
    ls, lt, lem, sym, lens = _setup(rng, make_hmm)
    good = [_t(ls), _t(lt), _t(lem), _t(sym), _t(lens)]
    bad_dtype = list(good)
    bad_dtype[3] = good[3].to(torch.int64)
    with pytest.raises(TypeError, match="symbols"):
        ck.viterbi_fwd(*bad_dtype)
    bad_shape = list(good)
    bad_shape[1] = good[1][:-1]
    with pytest.raises(ValueError, match="log_trans"):
        ck.viterbi_fwd(*bad_shape)
    strided = list(good)
    strided[3] = torch.from_numpy(
        np.ascontiguousarray(np.swapaxes(sym, 0, 1))
    ).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ck.viterbi_fwd(*strided)
    obs = torch.zeros((4, 6, lt.shape[0]))
    with pytest.raises(ValueError, match="obs"):
        ck.viterbi_chunk_values(_t(lt), obs.transpose(0, 1),
                                torch.zeros((6, lt.shape[0])),
                                torch.zeros(6, dtype=torch.int32))


def _k1_close(got, want):
    """K1's plain version against the Pallas kernel, at the JAX
    package's engine tolerances (tests/test_pallas.py): loglik 1e-5
    relative, statistics 1e-4 relative with 1e-5 / 1e-4 absolute."""
    start, pair, em_c, ll = (np.asarray(x) for x in got)
    w_start, w_pair, w_em, w_ll = (np.asarray(x) for x in want)
    np.testing.assert_allclose(ll, w_ll, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(start, w_start, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pair, w_pair, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(em_c, w_em, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
def test_k1_plain_matches_pallas_v4(rng, make_hmm, zero_frac):
    """K1: em_counts_fused on CPU tensors (its plain version) against
    em_counts_fused_pallas_v4 in interpret mode, ragged lengths."""
    ls, lt, lem = (x.astype(np.float32)
                   for x in make_hmm(5, 3, 6, zero_trans_frac=zero_frac))
    sym = rng.randint(0, 6, size=(4, 37, 3)).astype(np.int32)
    lens = np.asarray([37, 20, 1, 0], np.int32)
    want = pk.em_counts_fused_pallas_v4(
        jnp.asarray(ls), jnp.asarray(lt), jnp.asarray(lem),
        jnp.asarray(sym), jnp.asarray(lens),
    )
    got = ck.em_counts_fused(_t(ls), _t(lt), _t(lem), _t(sym), _t(lens))
    _k1_close([g.numpy() for g in got], want)
    assert got[3].numpy()[3] == 0.0             # zero-length row


def test_k1_plain_multigroup_column_order(rng, make_hmm, monkeypatch):
    """More rows than one Pallas batch group (G = 3): per-row logliks
    come back in the original row order in both."""
    monkeypatch.setattr(pk, "_pick_batch_group_v4", lambda *a, **k: 128)
    ls, lt, lem, _, _ = _setup(rng, make_hmm, S=3, T=2, V=5)
    sym = rng.randint(1, 5, size=(257, 9, 2)).astype(np.int32)
    lens = rng.randint(0, 10, size=(257,)).astype(np.int32)
    want = pk.em_counts_fused_pallas_v4(
        jnp.asarray(ls), jnp.asarray(lt), jnp.asarray(lem),
        jnp.asarray(sym), jnp.asarray(lens),
    )
    got = ck.em_counts_fused(_t(ls), _t(lt), _t(lem), _t(sym), _t(lens))
    _k1_close([g.numpy() for g in got], want)


def test_k1_cpu_tensors_take_the_plain_version(rng, make_hmm):
    ls, lt, lem, sym, lens = _setup(rng, make_hmm)
    args = (_t(ls), _t(lt), _t(lem), _t(sym), _t(lens))
    got = ck.em_counts_fused(*args)
    want = ck.em_counts_fused_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    alpha, dm, m_raw = ck.em_fwd(*args)
    assert all(torch.equal(g, w) for g, w in
               zip((alpha, dm, m_raw), ck.em_fwd_plain(*args)))
    assert all(torch.equal(g, w) for g, w in zip(
        ck.em_bwd_stats(args[1], args[2], args[3], args[4], alpha, m_raw),
        ck.em_bwd_stats_plain(args[1], args[2], args[3], args[4], alpha,
                              m_raw),
    ))
    assert ck._lib is None


def test_k1_wrappers_check_their_arguments(rng, make_hmm):
    ls, lt, lem, sym, lens = _setup(rng, make_hmm)
    good = [_t(ls), _t(lt), _t(lem), _t(sym), _t(lens)]
    with pytest.raises(TypeError, match="lengths"):
        ck.em_fwd(*good[:4], good[4].to(torch.int64))
    with pytest.raises(ValueError, match="log_start"):
        ck.em_fwd(good[0][:-1], *good[1:])
    alpha, _, m_raw = ck.em_fwd(*good)
    with pytest.raises(ValueError, match="alpha"):
        ck.em_bwd_stats(good[1], good[2], good[3], good[4], alpha[:, :-1],
                        m_raw)
    with pytest.raises(ValueError, match="m_raw"):
        ck.em_bwd_stats(good[1], good[2], good[3], good[4], alpha,
                        m_raw.T.contiguous().T)
