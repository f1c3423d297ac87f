"""K5 (``viterbi_values``), K3's carry mode past its one-warp kernels
(``viterbi_chunk_values``, ``viterbi_carry`` from 240 states) and K8c
(``viterbi_pointers``) on their own kernels to 256 states, on the card:
the max-plus lanes step to 32 states (``viterbi_values_lanes_kernel``,
``viterbi_ptrs_lanes_kernel``, a warp a row) and the max-plus rows
kernels from 33 (``viterbi_values_rows_kernel``,
``viterbi_ptrs_rows_kernel``, ``csrc/scan_rows.cuh``), routed by
``ck.log_scan_route`` and counted under their own names
(``ck.scan_counter``).

Every output (K5's value rows and dm; K3's value rows and final carry;
K8c's pointers, last row and dm) equals the block tile's
(``viterbi_values_kernel``, ``viterbi_ptrs_kernel``, forced with
``ck.LOG_SCAN_MAX_STATES`` = 0 through ``tools.time_scans.block_tile``)
bit for bit: on ragged rows (lengths L, L - 5, 1, 0, 2), with and without
zero transitions, on tables of small integers whose candidates tie within
and across the rows kernels' four chains (where a pad read as 0 would
beat every real candidate), on all-zero tables (every candidate of a
step equal) at S % 4 != 0 too, and at each rows-a-block the launcher
takes by the batch's size (R = 1, 2, 4 and past one wave).  Two launches give
the same bits, and ``dp.viterbi_streaming`` and ``dp.viterbi_backpointers``
give ``dp.viterbi``'s paths."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp  # noqa: E402
from tehmm_tpu_torch.tools import time_scans  # noqa: E402

from test_cuda_engines import _obs_inputs  # noqa: E402

pytestmark = pytest.mark.cuda

# the lanes step's edges (1, 2, 5, 31, 32: S % 4 and the last lane), the
# rows kernels' (33, 35), their register rows (8 to 63 states, 16 to 127,
# 32 beyond), partial column groups, 255 and 256
VITERBI_STATES = [1, 2, 5, 20, 31, 32, 33, 35, 64, 100, 128, 200, 255, 256]
COUNTERS = ("viterbi_values", "viterbi_ptrs")
CARRY_STATES = [240, 241, 255, 256]


def _both(ls, lt, obs, lens):
    return (*ck.viterbi_values(ls, lt, obs, lens),
            *ck.viterbi_pointers(ls, lt, obs, lens))


def _bit_equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _against_block_tile(call, *args):
    """``call``'s outputs on its route and with the block tile forced."""
    got = call(*args)
    with time_scans.block_tile():
        want = call(*args)
    assert ck.LOG_SCAN_MAX_STATES == 256
    return got, want


def _integer_tables(rng, device, S, L, B=5):
    """(log_start, log_trans, obs, lengths) of small integers: every sum
    is exact, so candidates tie within and across chains everywhere."""
    ls = torch.from_numpy(-rng.randint(0, 3, size=S).astype(np.float32))
    lt = torch.from_numpy(
        -rng.randint(0, 3, size=(S, S)).astype(np.float32))
    obs = torch.from_numpy(
        -rng.randint(0, 3, size=(B, L, S)).astype(np.float32))
    lens = torch.tensor([L, max(L - 5, 0), 1, 0, min(2, L)][:B],
                        dtype=torch.int32)
    return tuple(x.to(device) for x in (ls, lt, obs, lens))


def _check_paths(ls, lt, obs, lens):
    want_p, want_s = dp.viterbi(ls, lt, obs, lens)
    for fn in (dp.viterbi_streaming, dp.viterbi_backpointers):
        path, score = fn(ls, lt, obs, lens)
        assert torch.equal(path, want_p), fn.__name__
        torch.testing.assert_close(score, want_s, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", VITERBI_STATES)
def test_viterbi_bit_for_bit_the_block_tile(device, rng, S, zero_frac):
    """K5's rows and dm and K8c's pointers, last row and dm of the lanes
    step (to 32 states) and the rows kernels (33 to 256) equal the block
    tile's, forced, bit for bit, on the ragged rows; one launch a call
    under the route's own counter (the forced block tile's under the
    scan's name); repeats
    bit-identical; the plain versions' bits; rows of length 0 all zero
    with dm 0 and identity pointers; the paths dp.viterbi's."""
    ls, lt, obs, _p, _m, lens = _obs_inputs(rng, device, S, 37, zero_frac)
    route = ck.log_scan_route(S)
    assert route == ("lanes" if S <= 32 else "rows")
    before = dict(ck.LAUNCHES)
    got, want = _against_block_tile(_both, ls, lt, obs, lens)
    for name in COUNTERS:
        own = ck.scan_counter(name, S)
        assert own == f"{name}_{route}"
        assert ck.LAUNCHES[own] == before[own] + 1
        assert ck.LAUNCHES[name] == before[name] + 1
    assert _bit_equal(got, want)
    assert _bit_equal(_both(ls, lt, obs, lens), got)
    assert _bit_equal(got[:2], ck.viterbi_values_plain(ls, lt, obs, lens))
    assert _bit_equal(got[2:], ck.viterbi_pointers_plain(ls, lt, obs, lens))
    v, dm, ptrs, v_last, p_dm = got
    assert ptrs.dtype == torch.uint8
    assert torch.equal(v_last, v[:, -1]) and torch.equal(p_dm, dm)
    assert bool((v[lens == 0] == 0).all())
    assert bool((dm[lens == 0] == 0).all())
    ident = torch.arange(S, device=device).to(torch.uint8)
    assert bool((ptrs[lens == 0] == ident).all())
    assert bool((ptrs[:, 0] == ident).all())
    _check_paths(ls, lt, obs, lens)


@pytest.mark.parametrize("S", [5, 31, 33, 35, 64, 255, 256])
def test_viterbi_ties_and_pads(device, rng, S):
    """Ties within and across chains (tables of small integers) and every
    candidate of a step equal (all-zero log_trans and obs: the lowest
    state wins, and at S % 4 != 0 no pad of the rows kernels takes a max
    or a pointer): the block tile's bits, the plain versions' and
    dp.viterbi's paths."""
    for args in (_integer_tables(rng, device, S, 23),
                 tuple(torch.zeros_like(x) if x.is_floating_point() else x
                       for x in _integer_tables(rng, device, S, 9))):
        got, want = _against_block_tile(_both, *args)
        assert _bit_equal(got, want)
        assert _bit_equal(got[2:], ck.viterbi_pointers_plain(*args))
        assert _bit_equal(got[:2], ck.viterbi_values_plain(*args))
        _check_paths(*args)
    ptrs, lens = got[2], args[3]
    # all-zero tables: past position 0 every valid pointer is state 0
    for b, n in enumerate(lens.tolist()):
        assert bool((ptrs[b, 1:n] == 0).all())


def _rows_batches(S, kind):
    """Batches about the edges of one wave at each R of the rows kernel
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
def test_viterbi_rows_within_and_past_one_wave(device, rng, S):
    """The rows kernels at each R the launcher takes by the batch's size:
    R = 1, 2 and 4 within one wave and R = 4 past it.  Every output
    equals the block tile's, forced, bit for bit; the first five rows'
    bits are those of the five alone."""
    L = 6
    calls = {"viterbi_values": ck.viterbi_values,
             "viterbi_ptrs": ck.viterbi_pointers}
    for kind, call in calls.items():
        batches = _rows_batches(S, kind)
        assert {R for _, R, _ in batches} == {1, 2, 4}, batches
        assert any(waves for _, _, waves in batches), batches
        B_max = max(b for b, _, _ in batches)
        ls, lt, obs_all, _p, _m, lens_all = _obs_inputs(
            rng, device, S, L, zero_frac=0.3, rows=-(-B_max // 5))
        for B, R, _waves in batches:
            assert ck.library_rows_plan(S, B, kind)["R"] == R, (B, R)
            obs, lens = obs_all[:B].contiguous(), lens_all[:B].contiguous()
            got, want = _against_block_tile(call, ls, lt, obs, lens)
            assert _bit_equal(got, want), (B, R, kind)
            part = call(ls, lt, obs[:5].contiguous(), lens[:5])
            assert all(torch.equal(g[:5], p) for g, p in zip(got, part)), \
                (B, R, kind)


@pytest.mark.parametrize("S,rows", [(5, 12000), (32, 3000)])
def test_viterbi_lanes_many_blocks(device, rng, S, rows):
    """The lanes step on batches of thousands of blocks (a warp a row,
    four rows a block, the last block ragged): the block tile's bits,
    forced, and the first five rows' bits those of the five alone."""
    ls, lt, obs, _p, _m, lens = _obs_inputs(rng, device, S, 9,
                                            zero_frac=0.3, rows=rows)
    obs, lens = obs[:-2].contiguous(), lens[:-2].contiguous()
    got, want = _against_block_tile(_both, ls, lt, obs, lens)
    assert _bit_equal(got, want)
    part = _both(ls, lt, obs[:5].contiguous(), lens[:5])
    assert all(torch.equal(g[:5], p) for g, p in zip(got, part))


def _carry_inputs(rng, device, S, L, zero_frac):
    ls, lt, obs, _p, _m, lens = _obs_inputs(rng, device, S, L, zero_frac)
    init = torch.from_numpy(rng.randn(len(lens), S).astype(np.float32)) \
        .to(device)
    return lt, obs, init - init.amax(dim=-1, keepdim=True), lens


def _k3(lt, obs, init, lens):
    return (ck.viterbi_chunk_values(lt, obs, init, lens),
            ck.viterbi_carry(lt, obs, init, lens))


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", CARRY_STATES)
def test_k3_carry_mode_bit_for_bit_the_block_tile(device, rng, S,
                                                  zero_frac):
    """K3 past its one-warp kernels (240 to 256 states): the values mode's
    rows and the carry-only mode's final carry of K5's rows kernel equal
    the block tile's, forced, and the plain version's, bit for bit, under
    ``viterbi_chunk_rows`` (the block tile's under
    ``viterbi_chunk_tile``); a sweep cut into chunks gives the bits of
    one chunk; rows of length 0 keep their carry."""
    args = _carry_inputs(rng, device, S, 41, zero_frac)
    assert not ck.sweep_fits(S) and ck.k3_step(S) == "tile"
    assert ck.scan_counter("viterbi_chunk_tile", S) == "viterbi_chunk_rows"
    before = dict(ck.LAUNCHES)
    got, want = _against_block_tile(_k3, *args)
    assert ck.LAUNCHES["viterbi_chunk_rows"] == \
        before["viterbi_chunk_rows"] + 2
    assert ck.LAUNCHES["viterbi_chunk_tile"] == \
        before["viterbi_chunk_tile"] + 2
    assert _bit_equal(got, want)
    assert _bit_equal(got, (dp.viterbi_chunk_values(*args),
                            dp.viterbi_carry(*args)))
    assert _bit_equal(_k3(*args), got)
    v, carry = got
    lt, obs, init, lens = args
    assert torch.equal(carry, v[:, -1])
    assert torch.equal(carry[lens == 0], init[lens == 0])
    whole_carry = init
    for lo, hi in zip((0, 17, 40), (17, 40, 41)):
        pl = torch.clamp(lens - lo, 0, hi - lo).to(torch.int32)
        o = obs[:, lo:hi].contiguous()
        assert torch.equal(ck.viterbi_chunk_values(lt, o, whole_carry, pl),
                           v[:, lo:hi])
        whole_carry = ck.viterbi_carry(lt, o, whole_carry, pl)
    assert torch.equal(whole_carry, carry)


@pytest.mark.parametrize("S", [240, 256])
def test_k3_carry_mode_past_one_wave(device, rng, S):
    """K3's carry mode at each R the launcher takes by the batch's size
    (K5's plan): the block tile's bits, forced."""
    for B, R, _waves in _rows_batches(S, "viterbi_values"):
        lt, obs, init, lens = _carry_inputs(rng, device, S, 5, 0.3)
        reps = -(-B // len(lens))
        obs = obs.repeat(reps, 1, 1)[:B].contiguous()
        init = init.repeat(reps, 1)[:B].contiguous()
        lens = lens.repeat(reps)[:B].contiguous()
        got, want = _against_block_tile(_k3, lt, obs, init, lens)
        assert _bit_equal(got, want), (B, R)


@pytest.mark.parametrize("S", [33, 100, 256])
def test_viterbi_rows_plans(device, S):
    """K5's (and so K3's carry mode's) and K8c's rows plans: 32 ceil(S / 4
    / 8) threads, the register rows of ``rows_reg_chain`` and one row a
    block where a small batch fits one wave."""
    for kind in ("viterbi_values", "viterbi_ptrs"):
        plan = ck.library_rows_plan(S, 4, kind)
        assert plan["threads"] == 32 * (((S + 3) // 4 + 7) // 8)
        assert plan["KR"] == (8 if S < 64 else 16 if S < 128 else 32)
        assert plan["R"] == 1 and plan["per_sm"][1] >= 1, plan
