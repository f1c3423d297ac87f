"""The streaming kernels K5 (``viterbi_values``), K6a (``forward_prob``)
and K6b (``backward_prob``) against their plain-torch versions, on the
card.

K5 is float32 add, subtract and max only, so its value rows, normalizers
and the paths of ``dp.viterbi_streaming`` are bit-equal to the plain
versions.  K6 sums each S-term product as four interleaved FMA chains
where the plain version calls a matrix product, so alpha_p and beta_p
(values in [0, 1]) are held to 2e-6 absolute, the normalizers to 1e-5
absolute and the row logliks to 1e-5 relative; two launches give the
same bits.  Batches within and beyond one wave of blocks (one and two
rows per thread) are held to the same limits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.models import emission  # noqa: E402
from tehmm_tpu_torch.models.params import HmmParams  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp  # noqa: E402
from tehmm_tpu_torch.ops import em  # noqa: E402

from test_cuda_kernels import _inputs  # noqa: E402

pytestmark = pytest.mark.cuda

# 3: fewer states than one group of the product's four-way unroll; 5 and
# 20: several row groups per block; 72: three; 128: two; 200 and 256: one,
# and at 256 part of the matrix is read from global memory
STATES = [3, 5, 20, 72, 128, 200, 256]


def _obs_inputs(rng, device, S, L, zero_frac=0.0, rows=1):
    """(log_start, log_trans, obs, obs_p, o_m, lengths); ``rows`` copies
    of test_cuda_kernels' five ragged rows (lengths L, L-5, 1, 0, 2)."""
    ls, lt, lem, sym, lens = _inputs(rng, device, S, L, zero_frac=zero_frac)
    if rows > 1:
        sym = torch.from_numpy(rng.randint(
            0, lem.shape[2], size=(5 * rows, L, sym.shape[2])
        ).astype(np.int32)).to(device)
        lens = lens.repeat(rows)
    obs = emission.track_log_likelihoods(lem, sym)
    obs_p, o_m = dp.scaled_obs_prob(obs)
    return ls, lt, obs, obs_p, o_m, lens


def _loglik(alpha, dm, o_m, lens):
    valid = torch.arange(alpha.shape[1], device=alpha.device)[None, :] \
        < lens[:, None]
    ll = torch.log(alpha[:, -1].sum(dim=-1)) + dm.sum(dim=1) \
        + torch.where(valid, o_m, 0.0).sum(dim=1)
    return torch.where(lens > 0, ll, 0.0)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("L", [1, 37])
@pytest.mark.parametrize("S", STATES)
def test_viterbi_values_bit_equal(device, rng, S, L, zero_frac):
    ls, lt, obs, _p, _m, lens = _obs_inputs(rng, device, S, L, zero_frac)
    before = ck.LAUNCHES["viterbi_values"]
    v, dm = ck.viterbi_values(ls, lt, obs, lens)
    pv, pdm = ck.viterbi_values_plain(ls, lt, obs, lens)
    assert torch.equal(v, pv) and torch.equal(dm, pdm)
    assert ck.LAUNCHES["viterbi_values"] == before + 1
    assert bool((v[lens == 0] == 0).all()) and bool((dm[lens == 0] == 0).all())
    path, score = dp.viterbi_streaming(ls, lt, obs, lens)
    want_p, want_s = dp.viterbi(ls, lt, obs, lens)
    assert torch.equal(path, want_p)
    torch.testing.assert_close(score, want_s, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("L", [1, 37])
@pytest.mark.parametrize("S", STATES)
def test_prob_scans_match_plain(device, rng, S, L, zero_frac):
    ls, lt, _obs, obs_p, o_m, lens = _obs_inputs(rng, device, S, L,
                                                 zero_frac)
    before = dict(ck.LAUNCHES)
    alpha, dm = ck.forward_prob(ls, lt, obs_p, lens)
    beta = ck.backward_prob(lt, obs_p, lens)
    assert ck.LAUNCHES["fwd_prob"] == before["fwd_prob"] + 1
    assert ck.LAUNCHES["bwd_prob"] == before["bwd_prob"] + 1
    p_alpha, p_dm = ck.forward_prob_plain(ls, lt, obs_p, lens)
    p_beta = ck.backward_prob_plain(lt, obs_p, lens)
    torch.testing.assert_close(alpha, p_alpha, rtol=0, atol=2e-6)
    torch.testing.assert_close(dm, p_dm, rtol=0, atol=1e-5)
    torch.testing.assert_close(beta, p_beta, rtol=0, atol=2e-6)
    torch.testing.assert_close(_loglik(alpha, dm, o_m, lens),
                               _loglik(p_alpha, p_dm, o_m, lens),
                               rtol=1e-5, atol=1e-5)
    # empty rows: exactly ones and zeros; every row all ones from its
    # last valid position on
    assert bool((alpha[lens == 0] == 1).all())
    assert bool((dm[lens == 0] == 0).all())
    for b, n in enumerate(lens.tolist()):
        assert bool((beta[b, max(n - 1, 0):] == 1).all())
    # repeats give the same bits
    again = ck.forward_prob(ls, lt, obs_p, lens)
    assert torch.equal(alpha, again[0]) and torch.equal(dm, again[1])
    assert torch.equal(beta, ck.backward_prob(lt, obs_p, lens))


# (S, copies of the five ragged rows): batches of more blocks than an
# H100 holds at once at one row per thread (132 SMs, at most 8 blocks of
# 256 threads each; 256 / S row groups per block), so the launcher takes
# two rows per thread, beside a small batch of one row per thread
WAVES = [(5, 1), (5, 12000), (72, 7), (72, 700), (128, 7), (128, 250),
         (256, 7), (256, 28), (200, 30), (20, 3000), (3, 20000), (241, 28),
         (242, 28)]


@pytest.mark.parametrize("S,rows", WAVES)
def test_batches_within_and_beyond_one_wave(device, rng, S, rows):
    """Small batches (one row per thread) and batches past one wave (two
    rows per thread), the last block ragged, give the plain versions'
    results, and K6 the same bits at either: the order of each sum does
    not depend on the rows per thread."""
    L = 9
    ls, lt, obs, obs_p, _m, lens = _obs_inputs(rng, device, S, L,
                                               zero_frac=0.3, rows=rows)
    v, dm = ck.viterbi_values(ls, lt, obs, lens)
    pv, pdm = ck.viterbi_values_plain(ls, lt, obs, lens)
    assert torch.equal(v, pv) and torch.equal(dm, pdm)
    alpha, adm = ck.forward_prob(ls, lt, obs_p, lens)
    p_alpha, p_dm = ck.forward_prob_plain(ls, lt, obs_p, lens)
    torch.testing.assert_close(alpha, p_alpha, rtol=0, atol=2e-6)
    torch.testing.assert_close(adm, p_dm, rtol=0, atol=1e-5)
    beta = ck.backward_prob(lt, obs_p, lens)
    torch.testing.assert_close(beta, ck.backward_prob_plain(lt, obs_p, lens),
                               rtol=0, atol=2e-6)
    # the first five rows alone are a one-wave launch
    few = slice(0, 5)
    a5, d5 = ck.forward_prob(ls, lt, obs_p[few].contiguous(), lens[few])
    assert torch.equal(alpha[few], a5) and torch.equal(adm[few], d5)
    assert torch.equal(beta[few], ck.backward_prob(
        lt, obs_p[few].contiguous(), lens[few]))


@pytest.mark.parametrize("S", [241, 242, 256])
def test_backtrace_beyond_shared_memory(device, rng, S):
    """From S = 242 the backtrace kernel reads the last rows of log_trans
    from global memory; its paths stay the plain version's."""
    ls, lt, obs, _p, _m, lens = _obs_inputs(rng, device, S, 37,
                                            zero_frac=0.3, rows=8)
    v, _dm = ck.viterbi_values(ls, lt, obs, lens)
    end = torch.argmax(v[:, -1], dim=-1).to(torch.int32)
    body_lens = torch.clamp(lens - 1, min=0)
    before = ck.LAUNCHES["viterbi_backtrace"]
    got = ck.viterbi_backtrace(lt, v[:, 1:], v[:, 0], end, body_lens)
    assert ck.LAUNCHES["viterbi_backtrace"] == before + 1
    want = ck.viterbi_backtrace_plain(lt, v[:, 1:].contiguous(),
                                      v[:, 0].contiguous(), end, body_lens)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    path, _score = dp.viterbi_streaming(ls, lt, obs, lens)
    assert ck.LAUNCHES["viterbi_backtrace"] == before + 2
    assert torch.equal(path, dp.viterbi(ls, lt, obs, lens)[0])


def test_envelope_raises_naming_its_item(device, rng):
    S = ck.STREAMING_MAX_STATES + 1
    obs = torch.zeros((2, 3, S), device=device)
    lt = torch.zeros((S, S), device=device)
    ls = torch.zeros((S,), device=device)
    lens = torch.full((2,), 3, dtype=torch.int32, device=device)
    for call in (lambda: ck.viterbi_values(ls, lt, obs, lens),
                 lambda: ck.forward_prob(ls, lt, obs, lens),
                 lambda: ck.backward_prob(lt, obs, lens)):
        with pytest.raises(NotImplementedError, match="K5 and K6 beyond"):
            call()


@pytest.mark.parametrize("S", [10, 200, 256])
def test_cuda_v3_engine_matches_plain_engine(device, rng, S):
    """The E-step through K6 against the log-space engine on the card,
    at the engine tolerances (loglik 1e-5 relative, counts 1e-4 relative
    with 1e-5 / 1e-4 absolute); S = 200 and 256 are beyond K1."""
    ls, lt, lem, sym, lens = _inputs(rng, device, S, 37, zero_frac=0.3)
    p = HmmParams(ls, lt, lem)
    before = dict(ck.LAUNCHES)
    got = em.em_sufficient_stats(p, sym, lens, engine="cuda_v3")
    assert ck.LAUNCHES["fwd_prob"] == before["fwd_prob"] + 1
    assert ck.LAUNCHES["bwd_prob"] == before["bwd_prob"] + 1
    want = em.em_sufficient_stats(p, sym, lens, engine="plain")
    torch.testing.assert_close(got.loglik, want.loglik, rtol=1e-5, atol=0)
    for name, atol in (("start", 1e-5), ("trans", 1e-5), ("em", 1e-4)):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-4, atol=atol)
    if S > 150:
        with pytest.raises(NotImplementedError, match="K1 beyond"):
            em.em_sufficient_stats(p, sym, lens, engine="cuda")
