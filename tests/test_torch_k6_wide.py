"""K6a and K6b past 256 states on the CPU: the plain versions of
``forward_prob`` and ``backward_prob`` (the function of the card's cluster
tile and of its staged tile, which tests_cuda/test_cuda_large_s.py holds
bit for bit to each other there) against the JAX package's
``forward_prob_pallas_v3`` and ``backward_prob_pallas_v3`` in interpret
mode, at S = 300 and 512, on a few short ragged rows (one of length 0 and
blank), with and without zero transitions.

Tolerances are tests/test_pallas.py's: alpha_p and beta_p 2e-6 absolute
(values in [0, 1]), normalizers 1e-5 absolute, reassembled logliks 1e-5
relative."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu import oracle  # noqa: E402
from tehmm_tpu.ops import dp as jdp  # noqa: E402
from tehmm_tpu.ops import pallas_kernels as pk  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp as tdp  # noqa: E402

L = 9
LENGTHS = [9, 0, 1, 6]        # full, empty (blank obs), one position, short
T, V = 2, 4


@pytest.fixture(autouse=True)
def _nothing_launched():
    ck.reset_launch_counts()
    yield
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(rng, make_hmm, S, zero_frac):
    ls, lt, lem = make_hmm(S, T, V, zero_trans_frac=zero_frac)
    obs = np.stack([
        oracle.obs_log_likelihoods(lem, rng.randint(1, V, size=(L, T)))
        for _ in LENGTHS
    ]).astype(np.float32)
    obs[1] = 0.0
    lens = np.asarray(LENGTHS, np.int32)
    obs_p, o_m = tdp.scaled_obs_prob(_t(obs))
    return (np.asarray(ls, np.float32), np.asarray(lt, np.float32), obs,
            obs_p, o_m, lens)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", [300, 512])
def test_forward_prob_past_256_states_matches_pallas_v3(rng, make_hmm, S,
                                                        zero_frac):
    ls, lt, obs, obs_p, o_m, lens = _case(rng, make_hmm, S, zero_frac)
    want_a, want_dm = pk.forward_prob_pallas_v3(
        jnp.asarray(ls), jnp.asarray(lt), jnp.asarray(obs_p.numpy()),
        jnp.asarray(lens))
    alpha, dm = ck.forward_prob(_t(ls), _t(lt), obs_p, _t(lens))
    plain = ck.forward_prob_plain(_t(ls), _t(lt), obs_p, _t(lens))
    assert torch.equal(alpha, plain[0]) and torch.equal(dm, plain[1])
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want_a), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(dm.numpy(), np.asarray(want_dm), rtol=0,
                               atol=1e-5)
    # the reassembled loglik against the JAX log-space scan
    _, _, ll_ref = jdp.forward_scaled(jnp.asarray(ls), jnp.asarray(lt),
                                      jnp.asarray(obs), jnp.asarray(lens))
    valid = np.arange(L)[None, :] < lens[:, None]
    ll = (np.log(alpha.numpy()[:, -1].sum(-1)) + dm.numpy().sum(1)
          + (o_m.numpy() * valid).sum(1))
    ll = np.where(lens > 0, ll, 0.0)
    np.testing.assert_allclose(ll, np.asarray(ll_ref), rtol=1e-5)
    np.testing.assert_array_equal(alpha.numpy()[1], 1.0)
    np.testing.assert_array_equal(dm.numpy()[1], 0.0)
    # past a row's length the row is carried with a zero normalizer
    np.testing.assert_array_equal(alpha.numpy()[2, 1:],
                                  np.broadcast_to(alpha.numpy()[2, 0],
                                                  (L - 1, S)))
    np.testing.assert_array_equal(dm.numpy()[3, 6:], 0.0)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", [300, 512])
def test_backward_prob_past_256_states_matches_pallas_v3(rng, make_hmm, S,
                                                         zero_frac):
    ls, lt, obs, obs_p, _o_m, lens = _case(rng, make_hmm, S, zero_frac)
    want = pk.backward_prob_pallas_v3(
        jnp.asarray(lt), jnp.asarray(obs_p.numpy()), jnp.asarray(lens))
    beta = ck.backward_prob(_t(lt), obs_p, _t(lens))
    assert torch.equal(beta, ck.backward_prob_plain(_t(lt), obs_p,
                                                    _t(lens)))
    np.testing.assert_allclose(beta.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)
    bh_ref, _ = jdp.backward_scaled(jnp.asarray(lt), jnp.asarray(obs),
                                    jnp.asarray(lens))
    np.testing.assert_allclose(beta.numpy(), np.exp(np.asarray(bh_ref)),
                               rtol=0, atol=2e-6)
    for b, n in enumerate(lens):                 # ones from the end on
        np.testing.assert_array_equal(beta.numpy()[b, max(n - 1, 0):], 1.0)
