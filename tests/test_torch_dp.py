"""Port plain-torch Viterbi DP against ``tehmm_tpu.ops.dp``.

Both sides get the same float32 obs (made once from a seed), so value
rows and paths must agree exactly: every step is an exact max, add or
subtract.  The score of ``viterbi`` is a sum of normalizers and is held
to rtol 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.ops import dp as jdp  # noqa: E402
from tehmm_tpu_torch.ops import dp as tdp  # noqa: E402

# (S, L, lengths, zero_trans_frac)
CASES = [
    (3, 23, [23, 11, 1, 0], 0.0),
    (10, 23, [23, 11, 1, 0], 0.0),
    (3, 1, [1, 0, 1], 0.0),                  # L == 1: no transitions
    (10, 1, [1, 1], 0.0),
    (3, 17, [17, 9, 2], 0.5),                # LOG_ZERO transitions
    (10, 17, [17, 9, 2], 0.5),
    # past one state a lane of the card's backtrace (lanes own l + 32 k),
    # and past its shared-memory route (quads 4 l + 128 k + e from L2)
    (40, 13, [13, 6, 1, 0], 0.5),
    (257, 7, [7, 3, 1, 0], 0.5),
]


def _setup(rng, make_hmm, S, L, lengths, zero_frac):
    ls, lt, _ = make_hmm(S, 2, 4, zero_trans_frac=zero_frac)
    B = len(lengths)
    obs = (rng.randn(B, L, S) * 2.0).astype(np.float32)
    init = rng.randn(B, S).astype(np.float32)
    return (ls.astype(np.float32), lt.astype(np.float32), obs,
            np.asarray(lengths, np.int32), init)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("S,L,lengths,zero_frac", CASES)
def test_viterbi_matches_reference(rng, make_hmm, S, L, lengths,
                                   zero_frac):
    ls, lt, obs, lens, _ = _setup(rng, make_hmm, S, L, lengths, zero_frac)
    want_p, want_s = jdp.viterbi(
        jnp.asarray(ls), jnp.asarray(lt), jnp.asarray(obs),
        jnp.asarray(lens),
    )
    got_p, got_s = tdp.viterbi(_t(ls), _t(lt), _t(obs), _t(lens))
    assert got_p.dtype == torch.int32 and tuple(got_p.shape) == (len(lens), L)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_allclose(
        got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=0
    )


@pytest.mark.parametrize("S,L,lengths,zero_frac", CASES)
def test_carry_and_chunk_values_match_reference(rng, make_hmm, S, L,
                                                lengths, zero_frac):
    _, lt, obs, lens, init = _setup(
        rng, make_hmm, S, L, lengths, zero_frac
    )
    j_args = (jnp.asarray(lt), jnp.asarray(obs), jnp.asarray(init),
              jnp.asarray(lens))
    t_args = (_t(lt), _t(obs), _t(init), _t(lens))
    np.testing.assert_array_equal(
        tdp.viterbi_carry(*t_args).numpy(),
        np.asarray(jdp.viterbi_carry(*j_args)),
    )
    np.testing.assert_array_equal(
        tdp.viterbi_chunk_values(*t_args).numpy(),
        np.asarray(jdp.viterbi_chunk_values(*j_args)),
    )


@pytest.mark.parametrize("S,L,lengths,zero_frac", CASES)
def test_backtrace_chunk_matches_reference(rng, make_hmm, S, L, lengths,
                                           zero_frac):
    _, lt, obs, lens, init = _setup(
        rng, make_hmm, S, L, lengths, zero_frac
    )
    v_hats = np.asarray(jdp.viterbi_chunk_values(
        jnp.asarray(lt), jnp.asarray(obs), jnp.asarray(init),
        jnp.asarray(lens),
    ))
    end = rng.randint(0, S, size=len(lens)).astype(np.int32)
    want_p, want_e = jdp.viterbi_backtrace_chunk(
        jnp.asarray(lt), jnp.asarray(v_hats), jnp.asarray(init),
        jnp.asarray(end), jnp.asarray(lens),
    )
    got_p, got_e = tdp.viterbi_backtrace_chunk(
        _t(lt), _t(v_hats), _t(init), _t(end), _t(lens)
    )
    assert got_p.dtype == torch.int32 and got_e.dtype == torch.int32
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
