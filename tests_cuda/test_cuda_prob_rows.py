"""K6a (``forward_prob``) and K6b (``backward_prob``) on their own kernels
to 256 states, on the card: the lanes step to 32 states
(``fwd_prob_lanes_kernel``, ``bwd_prob_lanes_kernel``, a warp a row) and
the rows kernels from 33 (``fwd_prob_rows_kernel``,
``bwd_prob_rows_kernel``, ``csrc/scan_rows.cuh``), routed by
``ck.log_scan_route`` and counted under their own names
(``ck.scan_counter``).

Every output (alpha_p, dm, beta_p) equals the block tile's
(``fwd_prob_kernel``, ``bwd_prob_kernel``, forced with
``ck.LOG_SCAN_MAX_STATES`` = 0 through ``tools.time_scans.block_tile``)
bit for bit: on ragged rows (lengths L, L - 5, 1, 0, 2), with and without
zero transitions, with a row whose obs_p is zero at one position (its
product underflows to 0, so the 1e-37 floor of both maxima decides the
next values), at each rows-a-block the launcher takes by the batch's size
(R = 1, 2, 4 and past one wave) and through the ``cuda_v3`` E-step.  The
results stay within the limits of ``test_cuda_engines.py`` of the plain
version carried in float64 (alpha_p and beta_p 2e-6 absolute, dm 1e-5);
two launches give the same bits."""

import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.models.params import HmmParams  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import em  # noqa: E402
from tehmm_tpu_torch.tools import time_scans  # noqa: E402

from test_cuda_engines import _obs_inputs  # noqa: E402
from test_cuda_kernels import _inputs  # noqa: E402

pytestmark = pytest.mark.cuda

F64 = torch.float64
# the lanes step's edges (1, 2, 5, 31, 32: S % 4 and the last lane), the
# rows kernels' (33), their register rows (8 to 63 states, 16 to 127, 32
# beyond), partial column groups and 256
PROB_STATES = [1, 2, 5, 20, 31, 32, 33, 64, 100, 128, 200, 255, 256]
COUNTERS = ("fwd_prob", "bwd_prob")


def _both(ls, lt, obs_p, lens):
    return (*ck.forward_prob(ls, lt, obs_p, lens),
            ck.backward_prob(lt, obs_p, lens))


def _bit_equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _close_plain(got, ls, lt, obs_p, lens):
    r_alpha, r_dm = ck.forward_prob_plain(ls, lt, obs_p, lens, dtype=F64)
    r_beta = ck.backward_prob_plain(lt, obs_p, lens, dtype=F64)
    for g, r, atol in zip(got, (r_alpha, r_dm, r_beta), (2e-6, 1e-5, 2e-6)):
        torch.testing.assert_close(g, r.float(), rtol=0, atol=atol)


def _underflowing(obs_p, lens):
    """obs_p with the first row's position L // 2 zero: its product (and
    K6b's x at the position before) underflows to 0."""
    obs_p = obs_p.clone()
    t = int(lens[0]) // 2
    obs_p[0, t] = 0.0
    return obs_p


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", PROB_STATES)
def test_prob_scans_bit_for_bit_the_block_tile(device, rng, S, zero_frac):
    """alpha_p, dm and beta_p of the lanes step (to 32 states) and the
    rows kernels (33 to 256) equal the block tile's, forced, bit for bit,
    on the ragged rows with a row that underflows; one launch a call under
    the route's own counter and none of the block tile's; repeats
    bit-identical; within the limits of the plain version in float64;
    rows of length 0 all ones with dm 0; the forcing constant restored."""
    ls, lt, _obs, obs_p, _o_m, lens = _obs_inputs(rng, device, S, 37,
                                                  zero_frac)
    obs_p = _underflowing(obs_p, lens)
    route = ck.log_scan_route(S)
    assert route == ("lanes" if S <= 32 else "rows")
    before = dict(ck.LAUNCHES)
    got = _both(ls, lt, obs_p, lens)
    for name in COUNTERS:
        own = ck.scan_counter(name, S)
        assert own == f"{name}_{route}"
        assert ck.LAUNCHES[own] == before[own] + 1
        assert ck.LAUNCHES[name] == before[name]
    with time_scans.block_tile():
        assert ck.log_scan_route(S) == "narrow"
        want = _both(ls, lt, obs_p, lens)
    assert ck.LOG_SCAN_MAX_STATES == 256
    assert all(ck.LAUNCHES[k] == before[k] + 1 for k in COUNTERS)
    assert _bit_equal(got, want)
    assert _bit_equal(_both(ls, lt, obs_p, lens), got)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    alpha, dm, beta = got
    t = int(lens[0]) // 2
    assert bool((alpha[0, t:int(lens[0])] == 0).all())
    assert bool((beta[0, :t] == 0).all())
    assert bool((alpha[lens == 0] == 1).all())
    assert bool((dm[lens == 0] == 0).all())
    for b, n in enumerate(lens.tolist()):
        assert bool((beta[b, max(n - 1, 0):] == 1).all())
    _close_plain(got, ls, lt, obs_p, lens)


def _rows_batches(S, kind):
    """Batches about the edges of one wave at each R of K6's rows kernel
    ``kind`` at S states (``ck.library_rows_plan``), each with the R the
    launcher's rule gives it (the fewest rows a block whose grid fits one
    wave, else 4) and whether its grid runs past one wave."""
    plan = ck.library_rows_plan(S, 1, kind)
    wave = {R: plan["per_sm"][R] * plan["sms"] * R for R in (1, 2, 4)}
    assert all(wave.values()), plan
    out = []
    for B in sorted({w + d for w in wave.values() for d in (0, 1)}
                    | {3 * wave[4] + 7}):
        R = next((R for R in (1, 2, 4) if B <= wave[R]), 4)
        out.append((B, R, -(-B // R) > wave[R] // R))
    return out


@pytest.mark.parametrize("S", [33, 64, 128, 200, 256])
def test_prob_rows_within_and_past_one_wave(device, rng, S):
    """The rows kernels at each R the launcher takes by the batch's size:
    R = 1, 2 and 4 within one wave and R = 4 past it.  Every output
    equals the block tile's, forced, bit for bit; the rows' bits are those
    of the first five rows alone; the batches past one wave within the
    limits of the plain version carried in float64."""
    L = 6
    for kind in ("fwd_prob", "bwd_prob"):
        batches = _rows_batches(S, kind)
        assert {R for _, R, _ in batches} == {1, 2, 4}, batches
        assert any(waves for _, _, waves in batches), batches
        B_max = max(b for b, _, _ in batches)
        ls, lt, _obs, obs_all, _o_m, lens_all = _obs_inputs(
            rng, device, S, L, zero_frac=0.3, rows=-(-B_max // 5))
        for B, R, waves in batches:
            assert ck.library_rows_plan(S, B, kind)["R"] == R, (B, R)
            obs_p, lens = obs_all[:B].contiguous(), lens_all[:B].contiguous()
            if kind == "bwd_prob":
                def call(o, n):
                    return (ck.backward_prob(lt, o, n),)
            else:
                def call(o, n):
                    return ck.forward_prob(ls, lt, o, n)
            got = call(obs_p, lens)
            with time_scans.block_tile():
                want = call(obs_p, lens)
            assert _bit_equal(got, want), (B, R, kind)
            part = call(obs_p[:5].contiguous(), lens[:5])
            assert all(torch.equal(g[:5], p) for g, p in zip(got, part)), \
                (B, R, kind)
            if waves:
                if kind == "bwd_prob":
                    ref = (ck.backward_prob_plain(lt, obs_p, lens,
                                                  dtype=F64),)
                else:
                    ref = ck.forward_prob_plain(ls, lt, obs_p, lens,
                                                dtype=F64)
                for g, r in zip(got, ref):
                    torch.testing.assert_close(g, r.float(), rtol=0,
                                               atol=2e-6 if g.dim() == 3
                                               else 1e-5)


@pytest.mark.parametrize("S,rows", [(5, 12000), (32, 3000)])
def test_prob_lanes_many_blocks(device, rng, S, rows):
    """The lanes step on batches of thousands of blocks (a warp a row,
    four rows a block, the last block ragged): the block tile's bits,
    forced, and the first five rows' bits those of the five alone."""
    ls, lt, _obs, obs_p, _o_m, lens = _obs_inputs(rng, device, S, 9,
                                                  zero_frac=0.3, rows=rows)
    obs_p, lens = obs_p[:-2].contiguous(), lens[:-2].contiguous()
    got = _both(ls, lt, obs_p, lens)
    with time_scans.block_tile():
        want = _both(ls, lt, obs_p, lens)
    assert _bit_equal(got, want)
    part = _both(ls, lt, obs_p[:5].contiguous(), lens[:5])
    assert all(torch.equal(g[:5], p) for g, p in zip(got, part))


@pytest.mark.parametrize("S", [10, 32, 33, 200, 256])
def test_cuda_v3_estep_bit_for_bit_the_block_tile(device, rng, S):
    """The ``cuda_v3`` E-step (``"auto"`` past K1's envelope) through K6's
    own kernels gives the statistics it gives with the block tile forced,
    bit for bit, and launches each of K6a and K6b once under its route's
    counter (the block tile's once each when forced)."""
    ls, lt, lem, sym, lens = _inputs(rng, device, S, 37, zero_frac=0.3)
    p = HmmParams(ls, lt, lem)
    before = dict(ck.LAUNCHES)
    got = em.em_sufficient_stats(p, sym, lens, engine="cuda_v3")
    with time_scans.block_tile():
        want = em.em_sufficient_stats(p, sym, lens, engine="cuda_v3")
    for name in COUNTERS:
        own = ck.scan_counter(name, S)
        assert own != name
        assert ck.LAUNCHES[own] == before[own] + 1
        assert ck.LAUNCHES[name] == before[name] + 1
    for field in ("start", "trans", "em", "loglik", "n_obs"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
