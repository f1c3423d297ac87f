"""The log-space scans K7a/K8a (``forward_scaled``) and K7b/K8b
(``backward_scaled``), the pointer-writing Viterbi K8c
(``viterbi_pointers``) and its chase (``pointer_chase``) against their
plain-torch versions on the card, and the paths built on them: the
E-step engine ``"cuda_log"``, ``"auto"`` past K1's envelope and the
stitched decoders past K2's and K4's.

The scans sum each S-term product as four interleaved FMA chains where
the plain version calls a matrix product, and take accurate expf/logf, so
they are held, as ``tests/test_pallas.py`` holds the Pallas kernels, to
the plain version carried in float64: alpha_hat and beta_hat within 1e-5
absolute, log_c and log_d within 1e-4 absolute, logliks within 1e-6
relative (and 1e-6 absolute); two launches give the same bits.  K8c is
float32 add, subtract and max only: its pointers, last rows, normalizers
and the chased paths are bit-equal to the plain versions and the paths
to ``dp.viterbi``'s.

S = 5 and 72 have several row groups per block, 239 and 240 one; at one
row per thread every matrix row of S <= 240 sits in shared memory, at two
rows per thread S = 240 reads 4 rows through the read-only path and
S = 256 reads 32 (one row) or 36 (two).

To 256 states K7a/K8a, K7b/K8b and X1's and X2's carry modes run their
own kernels (``ck.log_scan_route``: the lanes step to 32 states, the rows
kernels beyond), each counted under its own name (``ck.scan_counter``);
every output of theirs equals the block tile's, forced with
``ck.LOG_SCAN_MAX_STATES`` = 0 (``tools.time_scans.block_tile``), bit
for bit, at each rows-a-block the rows kernels take by the batch's size
(``ck.library_rows_plan``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.models import emission  # noqa: E402
from tehmm_tpu_torch.models.params import HmmParams, from_numpy  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp  # noqa: E402
from tehmm_tpu_torch.ops import em  # noqa: E402
from tehmm_tpu_torch.parallel import stitch  # noqa: E402

from tehmm_tpu_torch.tools import time_scans  # noqa: E402

from test_cuda_kernels import _inputs, _model  # noqa: E402

pytestmark = pytest.mark.cuda

STATES = [5, 72, 239, 240, 256]
F64 = torch.float64


def _obs_inputs(rng, device, S, L, zero_frac=0.0, rows=1):
    """(log_start, log_trans, obs, lengths); ``rows`` copies of
    test_cuda_kernels' five ragged rows (lengths L, L-5, 1, 0, 2)."""
    ls, lt, lem, sym, lens = _inputs(rng, device, S, L, zero_frac=zero_frac)
    if rows > 1:
        sym = torch.from_numpy(rng.randint(
            0, lem.shape[2], size=(5 * rows, L, sym.shape[2])
        ).astype(np.int32)).to(device)
        lens = lens.repeat(rows)
    return ls, lt, emission.track_log_likelihoods(lem, sym), lens


def _close_scaled(got, want):
    """The forward's or the backward's outputs within the stated limits of
    the float64 plain version."""
    rows, cum = got[0], got[1]
    torch.testing.assert_close(rows, want[0].float(), rtol=0, atol=1e-5)
    torch.testing.assert_close(cum, want[1].float(), rtol=0, atol=1e-4)
    if len(got) == 3:
        # atol: a one-position row of missing symbols has loglik
        # logsumexp(log_start) = 0, which float32 holds to ~1e-9
        torch.testing.assert_close(got[2], want[2].float(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("L", [1, 37])
@pytest.mark.parametrize("S", STATES)
def test_log_scans_match_plain(device, rng, S, L, zero_frac):
    ls, lt, obs, lens = _obs_inputs(rng, device, S, L, zero_frac)
    before = dict(ck.LAUNCHES)
    fwd = ck.forward_scaled(ls, lt, obs, lens)
    bwd = ck.backward_scaled(lt, obs, lens)
    for name in ("fwd_scaled", "bwd_scaled"):
        own = ck.scan_counter(name, S)
        assert ck.LAUNCHES[own] == before[own] + 1
    _close_scaled(fwd, ck.forward_scaled_plain(ls, lt, obs, lens, dtype=F64))
    _close_scaled(bwd, ck.backward_scaled_plain(lt, obs, lens, dtype=F64))
    # the reference's carries: a zero-length row is zeros with log_c at
    # LOG_ZERO and loglik 0; beta_hat is 0 from each row's last valid
    # position on
    empty = lens == 0
    assert bool((fwd[0][empty] == 0).all())
    assert bool((fwd[2][empty] == 0).all())
    for b, n in enumerate(lens.tolist()):
        assert bool((bwd[0][b, max(n - 1, 0):] == 0).all())
        assert bool((bwd[1][b, max(n - 1, 0):] == 0).all())
    # repeats give the same bits
    again = ck.forward_scaled(ls, lt, obs, lens)
    assert all(torch.equal(a, b) for a, b in zip(fwd, again))
    assert all(torch.equal(a, b)
               for a, b in zip(bwd, ck.backward_scaled(lt, obs, lens)))


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("L", [1, 37])
@pytest.mark.parametrize("S", STATES)
def test_viterbi_pointers_bit_equal(device, rng, S, L, zero_frac):
    ls, lt, obs, lens = _obs_inputs(rng, device, S, L, zero_frac)
    before = dict(ck.LAUNCHES)
    ptrs, v_last, dm = ck.viterbi_pointers(ls, lt, obs, lens)
    want = ck.viterbi_pointers_plain(ls, lt, obs, lens)
    assert ptrs.dtype == torch.uint8
    assert torch.equal(ptrs, want[0]) and torch.equal(v_last, want[1]) \
        and torch.equal(dm, want[2])
    # the last row and the normalizers are K5's
    v, vdm = ck.viterbi_values(ls, lt, obs, lens)
    assert torch.equal(v_last, v[:, -1]) and torch.equal(dm, vdm)
    path = ck.pointer_chase(ptrs, v_last, lens)
    assert torch.equal(path, ck.pointer_chase_plain(ptrs, v_last, lens))
    own = ck.scan_counter("viterbi_ptrs", S)
    assert ck.LAUNCHES[own] == before[own] + 1
    assert ck.LAUNCHES["pointer_chase"] == before["pointer_chase"] + 1
    got_p, got_s = dp.viterbi_backpointers(ls, lt, obs, lens)
    want_p, want_s = dp.viterbi(ls, lt, obs, lens)
    assert torch.equal(got_p, path) and torch.equal(got_p, want_p)
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-4)


def test_pointers_take_the_lowest_state_on_ties(device):
    """Equal candidates (a uniform matrix, equal observations): every
    pointer is state 0, as the plain version's first-hit argmax."""
    S, L = 72, 6
    lt = torch.full((S, S), float(np.log(1.0 / S)), device=device)
    ls = torch.full((S,), float(np.log(1.0 / S)), device=device)
    obs = torch.zeros((3, L, S), device=device)
    lens = torch.tensor([L, 3, 0], dtype=torch.int32, device=device)
    ptrs, v_last, dm = ck.viterbi_pointers(ls, lt, obs, lens)
    want = ck.viterbi_pointers_plain(ls, lt, obs, lens)
    assert torch.equal(ptrs, want[0]) and torch.equal(v_last, want[1])
    assert bool((ptrs[0, 1:] == 0).all())
    ident = torch.arange(S, device=device, dtype=torch.uint8)
    assert bool((ptrs[1, 3:] == ident).all())
    assert bool((ptrs[2] == ident).all())


# (S, copies of the five ragged rows): batches past one wave of blocks
# (two rows per thread) beside the first five rows alone (one)
WAVES = [(5, 12000), (72, 700), (240, 28), (256, 28)]


@pytest.mark.parametrize("S,rows", WAVES)
def test_batches_within_and_beyond_one_wave(device, rng, S, rows):
    """Past one wave the launcher takes two rows per thread: the results
    stay the plain versions', and the same bits as one row per thread
    gives the first five rows."""
    L = 9
    ls, lt, obs, lens = _obs_inputs(rng, device, S, L, zero_frac=0.3,
                                    rows=rows)
    fwd = ck.forward_scaled(ls, lt, obs, lens)
    _close_scaled(fwd, ck.forward_scaled_plain(ls, lt, obs, lens, dtype=F64))
    bwd = ck.backward_scaled(lt, obs, lens)
    _close_scaled(bwd, ck.backward_scaled_plain(lt, obs, lens, dtype=F64))
    ptrs, v_last, dm = ck.viterbi_pointers(ls, lt, obs, lens)
    want = ck.viterbi_pointers_plain(ls, lt, obs, lens)
    assert torch.equal(ptrs, want[0]) and torch.equal(v_last, want[1]) \
        and torch.equal(dm, want[2])
    # the kernels' rows are the same bits; log_c, log_d and the logliks
    # are torch's reductions over them, whose order may follow the
    # batch's size, so they are held to float32 rounding
    few = slice(0, 5)
    obs5, lens5 = obs[few].contiguous(), lens[few]
    for whole, part in ((fwd, ck.forward_scaled(ls, lt, obs5, lens5)),
                        (bwd, ck.backward_scaled(lt, obs5, lens5))):
        assert torch.equal(whole[0][few], part[0])
        for a, b in zip(whole[1:], part[1:]):
            torch.testing.assert_close(a[few], b, rtol=1e-6, atol=1e-5)
    p5 = ck.viterbi_pointers(ls, lt, obs5, lens5)
    assert torch.equal(ptrs[few], p5[0]) and torch.equal(v_last[few], p5[1])


def test_envelope_raises_naming_its_item(device):
    S = ck.STREAMING_MAX_STATES + 1
    obs = torch.zeros((2, 3, S), device=device)
    lt = torch.zeros((S, S), device=device)
    ls = torch.zeros((S,), device=device)
    lens = torch.full((2,), 3, dtype=torch.int32, device=device)
    for call in (lambda: ck.forward_scaled(ls, lt, obs, lens),
                 lambda: ck.backward_scaled(lt, obs, lens),
                 lambda: ck.viterbi_pointers(ls, lt, obs, lens)):
        with pytest.raises(NotImplementedError, match="tile beyond 1024"):
            call()


@pytest.mark.parametrize("S", [10, 200, 256])
def test_cuda_log_engine_matches_plain_engine(device, rng, S):
    """The E-step through K7a/K7b against the log-space engine in plain
    torch on the card, at the engine tolerances."""
    ls, lt, lem, sym, lens = _inputs(rng, device, S, 37, zero_frac=0.3)
    p = HmmParams(ls, lt, lem)
    before = dict(ck.LAUNCHES)
    got = em.em_sufficient_stats(p, sym, lens, engine="cuda_log")
    for name in ("fwd_scaled", "bwd_scaled"):
        own = ck.scan_counter(name, S)
        assert ck.LAUNCHES[own] == before[own] + 1
    want = em.em_sufficient_stats(p, sym, lens, engine="plain")
    torch.testing.assert_close(got.loglik, want.loglik, rtol=1e-5, atol=0)
    for name, atol in (("start", 1e-5), ("trans", 1e-5), ("em", 1e-4)):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-4, atol=atol)


@pytest.mark.parametrize("S", [148, 160])
def test_auto_takes_k1_where_it_fits_and_cuda_v3_beyond(device, rng, S):
    """At T=5, V=9 K1 takes S <= 148: ``"auto"`` runs it there and the
    probability-space scans beyond, never the plain engine."""
    ls, lt, lem, sym, lens = _inputs(rng, device, S, 37, T=5, V=9)
    p = HmmParams(ls, lt, lem)
    before = dict(ck.LAUNCHES)
    got = em.em_sufficient_stats(p, sym, lens)
    fits = S <= 148
    assert ck.k1_fits(S, 5, 9) == fits
    assert (ck.LAUNCHES["em_fwd"] > before["em_fwd"]) == fits
    k6a = ck.scan_counter("fwd_prob", S)
    assert (ck.LAUNCHES[k6a] > before[k6a]) == (not fits)
    want = em.em_sufficient_stats(p, sym, lens, engine="plain")
    torch.testing.assert_close(got.loglik, want.loglik, rtol=1e-5, atol=0)
    torch.testing.assert_close(got.trans, want.trans, rtol=1e-4, atol=1e-5)


def test_stitched_decoders_past_the_fused_envelopes(device, rng):
    """At S = 256 K2 and K4 do not fit: the stitched Viterbi runs obs, K5
    and the backtrace kernel and gives the CPU's paths; the stitched
    max-posterior runs K7a/K7b and agrees with the CPU on >= 99.9% of
    positions."""
    S = 256
    tables = _model(rng, S, 3, 6)
    assert not ck.k2_fits(S, 3, 6) and not ck.k4_fits(S, 3, 6)
    syms = [rng.randint(1, 6, size=(n, 3)).astype(np.uint8)
            for n in (3000, 1201)]
    on_gpu = from_numpy(*tables, device)
    on_cpu = from_numpy(*tables, "cpu")
    before = dict(ck.LAUNCHES)
    got = stitch.viterbi_chunked(on_gpu, syms, chunk_len=512, halo=32)[0]
    k5 = ck.scan_counter("viterbi_values", S)
    assert ck.LAUNCHES[k5] > before[k5]
    assert ck.LAUNCHES["viterbi_fwd"] == before["viterbi_fwd"]
    for g, c in zip(got, stitch.viterbi_chunked(on_cpu, syms, chunk_len=512,
                                                halo=32)[0]):
        np.testing.assert_array_equal(g, c)
    got = stitch.posterior_chunked(on_gpu, syms, chunk_len=512, halo=32)[0]
    assert ck.LAUNCHES["fwd_scaled_rows"] > before["fwd_scaled_rows"]
    assert ck.LAUNCHES["fwd_scaled"] == before["fwd_scaled"]
    assert ck.LAUNCHES["post_decode"] == before["post_decode"]
    assert ck.LAUNCHES["post_decode_lanes"] == before["post_decode_lanes"]
    for g, c in zip(got, stitch.posterior_chunked(on_cpu, syms,
                                                  chunk_len=512,
                                                  halo=32)[0]):
        assert (g == c).mean() >= 0.999


@pytest.mark.parametrize("S", [256, 257])
def test_scans_take_the_cluster_tile_from_257_states(device, rng, S):
    """K7a/K7b on the rows kernels to 256 states, on the cluster tile from
    257 (``ck.scan_route``), each counted under its own name, both within
    the log-space limit of the plain versions carried in float64."""
    ls, lt, obs, lens = _obs_inputs(rng, device, S, 29, 0.3, rows=3)
    before = dict(ck.LAUNCHES)
    fwd = ck.forward_scaled(ls, lt, obs, lens)
    bwd = ck.backward_scaled(lt, obs, lens)
    moved = {k for k in ck.LAUNCHES if ck.LAUNCHES[k] != before[k]}
    assert moved == ({"fwd_scaled_cluster", "bwd_scaled_cluster"}
                     if S > 256 else {"fwd_scaled_rows", "bwd_scaled_rows"})
    lim = 1e-5 + 4 * float(np.finfo(np.float32).eps) \
        * float(obs.abs().max())
    ref = ck.forward_scaled_plain(ls, lt, obs, lens, dtype=torch.float64)
    torch.testing.assert_close(fwd[0], ref[0].float(), rtol=0, atol=lim)
    ref = ck.backward_scaled_plain(lt, obs, lens, dtype=torch.float64)
    torch.testing.assert_close(bwd[0], ref[0].float(), rtol=0, atol=lim)


# the lanes step's and the rows kernels' edges: 1-3, 31-33 (lanes / rows),
# the rows kernels' register rows (8 to 63 states, 16 to 127, 32 beyond),
# partial column groups (S % 4), the block tile's one-row-group edge (239,
# 240) and 256
LOG_STATES = [1, 2, 3, 5, 31, 32, 33, 63, 64, 65, 127, 128, 200, 239, 240,
              255, 256]


def _both_scans(ls, lt, obs, lens):
    return (*ck.forward_scaled(ls, lt, obs, lens),
            *ck.backward_scaled(lt, obs, lens))


def _bit_equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", LOG_STATES)
def test_log_scans_bit_for_bit_the_block_tile(device, rng, S, zero_frac):
    """alpha_hat, log_c, loglik, beta_hat and log_d of the lanes step (to
    32 states) and the rows kernels (33 to 256) equal the block tile's,
    forced, bit for bit, on the ragged rows (lengths L, L - 5, 1, 0, 2)
    with and without zero transitions; one launch a call under the route's
    own counter and none of the block tile's; repeats bit-identical;
    within the limits of the plain version carried in float64; the
    forcing constant restored."""
    ls, lt, obs, lens = _obs_inputs(rng, device, S, 37, zero_frac)
    route = ck.log_scan_route(S)
    assert route == ("lanes" if S <= 32 else "rows")
    before = dict(ck.LAUNCHES)
    got = _both_scans(ls, lt, obs, lens)
    for name in ("fwd_scaled", "bwd_scaled"):
        own = ck.scan_counter(name, S)
        assert own == f"{name}_{route}"
        assert ck.LAUNCHES[own] == before[own] + 1
        assert ck.LAUNCHES[name] == before[name]
    with time_scans.block_tile():
        assert ck.log_scan_route(S) == "narrow"
        want = _both_scans(ls, lt, obs, lens)
    assert ck.LOG_SCAN_MAX_STATES == 256
    assert ck.LAUNCHES["fwd_scaled"] == before["fwd_scaled"] + 1
    assert _bit_equal(got, want)
    assert _bit_equal(_both_scans(ls, lt, obs, lens), got)
    _close_scaled(got[:3], ck.forward_scaled_plain(ls, lt, obs, lens,
                                                   dtype=F64))
    _close_scaled(got[3:], ck.backward_scaled_plain(lt, obs, lens,
                                                    dtype=F64))


@pytest.mark.parametrize("S,rows", WAVES)
def test_log_scans_past_one_wave_bit_for_bit_the_block_tile(device, rng, S,
                                                            rows):
    """The block tile's batches past one wave of its own: every output the
    block tile's bits, forced, and the rows' bits those of the first five
    rows alone."""
    ls, lt, obs, lens = _obs_inputs(rng, device, S, 9, zero_frac=0.3,
                                    rows=rows)
    got = _both_scans(ls, lt, obs, lens)
    with time_scans.block_tile():
        want = _both_scans(ls, lt, obs, lens)
    assert _bit_equal(got, want)
    few = slice(0, 5)
    part = _both_scans(ls, lt, obs[few].contiguous(), lens[few])
    assert torch.equal(got[0][few], part[0])
    assert torch.equal(got[3][few], part[3])


def _rows_batches(S, backward):
    """Batches about the edges of one wave at each R of the rows kernels
    at S states (``ck.library_rows_plan``: the card's blocks an SM at R =
    1, 2 and 4), each with the R the launcher's rule gives it (the fewest
    rows a block whose grid fits one wave, else 4) and whether its grid
    runs past one wave."""
    plan = ck.library_rows_plan(S, 1, backward)
    wave = {R: plan["per_sm"][R] * plan["sms"] * R for R in (1, 2, 4)}
    assert all(wave.values()), plan
    out = []
    for B in sorted({w + d for w in wave.values() for d in (0, 1)}
                    | {3 * wave[4] + 7}):
        R = next((R for R in (1, 2, 4) if B <= wave[R]), 4)
        out.append((B, R, -(-B // R) > wave[R] // R))
    return out


@pytest.mark.parametrize("S", [33, 64, 128, 200, 256])
def test_rows_kernels_within_and_past_one_wave(device, rng, S):
    """The rows kernels at each R the launcher takes by the batch's size
    (``ck.library_rows_plan``): R = 1, 2 and 4 within one wave and R = 4
    past it (several waves).  Every output equals the block tile's,
    forced, bit for bit; the rows' bits are those of the first five rows
    alone; the batches past one wave within the limits of the plain
    version carried in float64."""
    L = 6
    for backward in (False, True):
        batches = _rows_batches(S, backward)
        assert {R for _, R, _ in batches} == {1, 2, 4}, batches
        assert any(waves for _, _, waves in batches), batches
        B_max = max(b for b, _, _ in batches)
        ls, lt, obs_all, lens_all = _obs_inputs(
            rng, device, S, L, zero_frac=0.3, rows=-(-B_max // 5))
        for B, R, waves in batches:
            assert ck.library_rows_plan(S, B, backward)["R"] == R, (B, R)
            obs, lens = obs_all[:B].contiguous(), lens_all[:B].contiguous()
            if backward:
                got = ck.backward_scaled(lt, obs, lens)
                with time_scans.block_tile():
                    want = ck.backward_scaled(lt, obs, lens)
                part = ck.backward_scaled(lt, obs[:5].contiguous(), lens[:5])
            else:
                got = ck.forward_scaled(ls, lt, obs, lens)
                with time_scans.block_tile():
                    want = ck.forward_scaled(ls, lt, obs, lens)
                part = ck.forward_scaled(ls, lt, obs[:5].contiguous(),
                                         lens[:5])
            assert _bit_equal(got, want), (B, R, backward)
            assert torch.equal(got[0][:5], part[0]), (B, R, backward)
            if waves:
                ref = (ck.backward_scaled_plain(lt, obs, lens, dtype=F64)
                       if backward else
                       ck.forward_scaled_plain(ls, lt, obs, lens, dtype=F64))
                _close_scaled(got, ref)


def _carry_modes(lt, obs, init, cont, lens):
    return (*ck.forward_chunk_values(lt, obs, init, lens),
            *ck.forward_final(lt, obs, init, lens),
            *ck.backward_chunk_values(lt, obs, init, cont, lens))


@pytest.mark.parametrize("S", [240, 256])
def test_carry_modes_bit_for_bit_the_block_tile(device, rng, S):
    """X1's (values and carry-only) and X2's carry modes on the rows
    kernel, counted as ``fwd_chunk_rows`` and ``bwd_chunk_rows``: the
    block tile's bits, forced; a sweep cut into chunks gives the bits of
    one chunk."""
    L = 60
    ls, lt, obs, _lens = _obs_inputs(rng, device, S, L, zero_frac=0.3)
    lens = torch.tensor([L, L, 33, 0, 1], dtype=torch.int32, device=device)
    init = torch.from_numpy(rng.randn(5, S).astype(np.float32)).to(device)
    init = init - init.amax(dim=-1, keepdim=True)
    # rows that run past the span are full rows
    cont = torch.tensor([True, True, False, False, False], device=device)
    assert not ck.sweep_fits(S) and ck.log_scan_route(S) == "rows"
    before = dict(ck.LAUNCHES)
    got = _carry_modes(lt, obs, init, cont, lens)
    assert ck.LAUNCHES["fwd_chunk_rows"] == before["fwd_chunk_rows"] + 2
    assert ck.LAUNCHES["bwd_chunk_rows"] == before["bwd_chunk_rows"] + 1
    assert ck.LAUNCHES["fwd_chunk_tile"] == before["fwd_chunk_tile"]
    with time_scans.block_tile():
        assert _bit_equal(got, _carry_modes(lt, obs, init, cont, lens))
    assert ck.LAUNCHES["fwd_chunk_tile"] == before["fwd_chunk_tile"] + 2
    hats, a_carry, final, _dm, beta, x_out = got
    assert torch.equal(final, a_carry)
    cuts = (0, 17, 40, L)

    def part_lens(lo, hi):
        return torch.clamp(lens - lo, 0, hi - lo).to(torch.int32)

    a_c = init
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        h, a_c = ck.forward_chunk_values(lt, obs[:, lo:hi].contiguous(),
                                         a_c, part_lens(lo, hi))
        assert torch.equal(h, hats[:, lo:hi])
    assert torch.equal(a_c, a_carry)
    x_c, continuing = init, cont
    for lo, hi in reversed(list(zip(cuts[:-1], cuts[1:]))):
        b, x_c = ck.backward_chunk_values(lt, obs[:, lo:hi].contiguous(),
                                          x_c, continuing, part_lens(lo, hi))
        assert torch.equal(b, beta[:, lo:hi])
        continuing = lens > lo
    assert torch.equal(x_c, x_out)
