"""The piece-operator scan (``ck.forward_loglik``: ``fwd_piece_ops`` then
``fwd_piece_compose``, the route of ``MultitrackHmm.score``) against
its plain version, on the card.

Limits (derived in PERF.md), against the plain versions in float64:
probability rows, carries within X1's F3 limit (1e-5 plus 4 float32
ulps of the largest finite |obs|); a sum of k normalizers (a piece's
log scale: k = PIECE; a piece's increment: k = 1; a chunk's: k = its
positions) within 1e-6 relative plus 1e-6 + k (S + max|obs|) float32
ulps of 1 absolute: each normalizer carries the rounding of an S-term
sum (S ulps of it, relative, so S ulps of 1 in its log) and of obs +
log(sum) (an ulp of |obs|), and a piece's terms may cancel.  Two launches give the same
bits; past ``PIECE_SCAN_MAX_STATES``, or past the rows
``ck.piece_scan_route`` gives the pieces at that S, the route takes
X1's chain, at S = 240 the tile's carry mode; the CLI's printed score on the card
equals the CPU's within 1e-5 relative."""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp  # noqa: E402
from tehmm_tpu_torch.utils.common import LOG_ZERO  # noqa: E402

from test_cuda_kernels import _model  # noqa: E402

pytestmark = pytest.mark.cuda

P = dp.PIECE
F64 = torch.float64
EPS32 = float(np.finfo(np.float32).eps)
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "data")

# (S, Lc, zero_frac, impossible) as tests/test_torch_opscan.py, and the
# one-warp kernels' widest S
CASES = [
    (1, 3 * P + 17, 0.0, False),
    (2, 3 * P + 17, 0.0, False),
    (10, 3 * P + 17, 0.0, False),
    (10, 2 * P, 0.0, False),
    (10, 3 * P + 17, 0.5, False),
    (10, 3 * P + 17, 0.0, True),
    (33, 2 * P + 40, 0.3, False),
    (64, P + 9, 0.0, True),
    (239, P + 9, 0.3, False),
]


def _inputs(rng, device, S, Lc, zero_frac=0.0, impossible=False):
    lt = _model(rng, S, 1, 2, zero_frac)[1]
    lens = np.minimum([Lc, 0, 1, P - 1, P, P + 1, P + P // 2 + 7], Lc)
    obs = (rng.randn(len(lens), Lc, S) * 3.0 - 4.0).astype(np.float32)
    if impossible:
        obs[0, P + 3, :] = LOG_ZERO
        obs[3, 5, : max(1, S // 2)] = LOG_ZERO
    init = rng.randn(len(lens), S).astype(np.float32)
    init -= init.max(axis=-1, keepdims=True)
    return [torch.from_numpy(np.asarray(x)).to(device)
            for x in (lt, obs, init, lens.astype(np.int32))]


def _f3(obs):
    finite = obs.abs()[obs.abs() < 1e29]
    return 1e-5 + 4 * EPS32 * float(finite.max())


def _held(got, want, lim, what):
    got, want = got.double(), want.double()
    finite = want > -1e29
    assert bool((got[~finite] < -1e29).all()), what
    err = (got - want).abs()[finite]
    worst = float(err.max()) if err.numel() else 0.0
    assert worst <= lim, f"{what}: max err {worst:.3g} > {lim:.3g}"


def _sum_atol(steps, S, obs):
    finite = obs.abs()[obs.abs() < 1e29]
    return 1e-6 + steps * EPS32 * (S + float(finite.max()))


def _close(got, want, what, atol=1e-6):
    got, want = got.double(), want.double()
    bad = (got - want).abs() > atol + 1e-6 * want.abs()
    assert not bool(bad.any()), f"{what}: {int(bad.sum())} values off"


@pytest.mark.parametrize("S,Lc,zero_frac,impossible", CASES)
def test_kernels_match_plain(device, rng, S, Lc, zero_frac, impossible):
    """Each phase against its plain version in float64 on the same
    inputs (phase B fed the kernel's operators), then the whole scan
    against the float64 chain; one launch of each kernel a call."""
    lt, obs, init, lens = _inputs(rng, device, S, Lc, zero_frac, impossible)
    lim = _f3(obs)
    before = dict(ck.LAUNCHES)
    probs, n = ck.piece_operators(lt, obs, lens)
    want_p, want_n = dp.piece_operators(lt, obs, lens, dtype=F64)
    live = (torch.arange(probs.shape[1], device=device)[None, :] * P
            < lens[:, None].long())
    # a piece through a position no state emits is held to the float32
    # plain version (float64 holds LOG_ZERO otherwise: see below)
    dead = (want_n < -1e29).any(dim=-1)
    ok = live & ~dead
    _held(probs[ok], want_p[ok], lim, "probability rows")
    _close(n[ok], want_n[ok], "log scales", _sum_atol(P, S, obs))
    f32_p, f32_n = dp.piece_operators(lt, obs, lens)
    _held(probs[live & dead], f32_p[live & dead], 2 * lim,
          "probability rows through an impossible position")
    assert bool((n[live & dead] < -1e29).all())

    carry, incs = ck.compose_pieces(probs, n, init, lens)
    want_c, want_i = dp.compose_pieces(probs.double(), n, init.double(),
                                       lens)
    _held(carry, want_c, lim, "composed carry")
    _close(incs, want_i, "piece increments", _sum_atol(1, S, obs))

    got_c, got_dm = carry, incs.sum(dim=1).float()
    ref_c, ref_dm = dp.forward_final(lt, obs, init, lens, dtype=F64)
    # rows through a position no state emits: float64 holds LOG_ZERO
    # otherwise than float32 (tests/test_torch_opscan.py), so those are
    # held to the float32 chain
    dead = ref_dm < -1e29
    _held(got_c[~dead], ref_c[~dead], lim, "carry vs float64 chain")
    _close(got_dm[~dead], ref_dm[~dead], "increments vs float64 chain",
           _sum_atol(Lc, S, obs))
    f32_c, f32_dm = dp.forward_final(lt, obs, init, lens)
    _held(got_c, f32_c, 2 * lim, "carry vs float32 chain")
    assert bool((got_dm[dead] < -1e29).all())
    assert torch.equal(got_c[1], init[1]) and float(got_dm[1]) == 0.0
    for name in ("fwd_piece_ops", "fwd_piece_compose"):
        assert ck.LAUNCHES[name] == before[name] + 1
    # the route: these kernels where piece_scan_route, the chain beyond
    routed = ck.forward_loglik(lt, obs, init, lens)
    if ck.piece_scan_route(len(lens), S):
        assert torch.equal(routed[0], got_c)
        assert torch.equal(routed[1], got_dm)
        assert ck.LAUNCHES["fwd_piece_ops"] == before["fwd_piece_ops"] + 2
    else:
        assert ck.LAUNCHES["fwd_chunk"] == before["fwd_chunk"] + 1


@pytest.mark.parametrize("S", [10, 64, 239])
def test_operator_rows_are_x1_carries(device, rng, S):
    """Row i of a piece's operator is exp of X1's carry from e_i over the
    piece, bit for bit: the pieces' step keeps X1's FMA order."""
    lt, obs, _init, lens = _inputs(rng, device, S, 2 * P + 40)
    probs, _n = ck.piece_operators(lt, obs, lens)
    e_i = torch.full((S, S), LOG_ZERO, device=device)
    e_i.fill_diagonal_(0.0)
    piece = obs[0, P : 2 * P].expand(S, P, S).contiguous()
    carry, _dm = ck.forward_final(lt, piece, e_i,
                                  torch.full((S,), P, dtype=torch.int32,
                                             device=device))
    assert torch.equal(torch.exp(carry), probs[0, 1])


@pytest.mark.parametrize("S", [10, 64, 239])
def test_two_launches_bit_identical(device, rng, S):
    lt, obs, init, lens = _inputs(rng, device, S, 3 * P + 17)
    one = ck.compose_pieces(*ck.piece_operators(lt, obs, lens), init, lens)
    two = ck.compose_pieces(*ck.piece_operators(lt, obs, lens), init, lens)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


def test_row_groups_give_the_bits_of_one_group(device, rng, monkeypatch):
    """Rows are independent: groups under a small byte cap give the bits
    of one launch over every row."""
    lt, obs, init, lens = _inputs(rng, device, 10, 3 * P + 17)
    one = ck.forward_loglik(lt, obs, init, lens)
    monkeypatch.setattr(ck, "_PIECE_OPS_BYTES", 1)
    before = ck.LAUNCHES["fwd_piece_ops"]
    grouped = ck.forward_loglik(lt, obs, init, lens)
    assert ck.LAUNCHES["fwd_piece_ops"] == before + len(lens)
    assert torch.equal(one[0], grouped[0])
    assert torch.equal(one[1], grouped[1])


def test_aligned_chunks_give_the_carry_of_one_chunk(device, rng):
    """Cut at multiples of PIECE, a row makes the same pieces, so its
    chunks chained give the carry of one chunk bit for bit."""
    lt, obs, init, lens = _inputs(rng, device, 10, 4 * P + 50)
    one_c, one_dm = ck.forward_loglik(lt, obs, init, lens)
    carry, total = init, torch.zeros_like(one_dm)
    cuts = (0, P, 3 * P, 4 * P + 50)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        part = torch.clamp(lens - lo, 0, hi - lo).to(torch.int32)
        carry, dm = ck.forward_loglik(lt, obs[:, lo:hi].contiguous(), carry,
                                      part)
        total = total + dm
    assert torch.equal(carry, one_c)
    _close(total, one_dm, "summed increments")


@pytest.mark.parametrize("S,rows,kernel", [
    (ck.PIECE_SCAN_MAX_STATES + 1, 7, "fwd_chunk"),
    (64, 33, "fwd_chunk"), (168, 5, "fwd_chunk"),
    (240, 7, "fwd_chunk_rows")])
def test_past_the_crossover_takes_the_chain(device, rng, S, rows, kernel):
    """Past ``PIECE_SCAN_MAX_STATES``, or past the rows
    ``piece_scan_route`` gives the pieces at S, ``forward_loglik``
    launches ``forward_final``'s kernel, X1's chain, and at S = 240,
    past ``sweep_fits``, the carry mode on the rows kernel; no piece
    kernel and no block tile."""
    lt, obs, init, lens = _inputs(rng, device, S, 300)
    take = torch.arange(rows, device=device) % len(lens)
    obs, init, lens = (obs[take].contiguous(), init[take].contiguous(),
                       lens[take].contiguous())
    assert not ck.piece_scan_route(rows, S)
    before = dict(ck.LAUNCHES)
    got = ck.forward_loglik(lt, obs, init, lens)
    assert ck.LAUNCHES[kernel] == before[kernel] + 1
    for name in ("fwd_piece_ops", "fwd_piece_compose", "fwd_chunk",
                 "fwd_chunk_tile", "fwd_chunk_rows"):
        if name != kernel:
            assert ck.LAUNCHES[name] == before[name]
    want = ck.forward_final(lt, obs, init, lens)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if S > 239:
        with pytest.raises(NotImplementedError, match="sweep_fits"):
            ck.piece_operators(lt, obs, lens)


def test_cli_score_on_the_card_equals_the_cpu(device, tmp_path, capsys):
    """``eval`` with no ``--bed`` prints log P(data): through the pieces
    on the card, through the chain on the CPU, within 1e-5 relative."""
    from tehmm_tpu_torch.cli import eval as port_eval
    from tehmm_tpu_torch.cli import train as port_train

    for f in os.listdir(DATA):
        if os.path.isfile(os.path.join(DATA, f)):
            shutil.copy(os.path.join(DATA, f), tmp_path / f)
    xml, model = str(tmp_path / "tracks.xml"), str(tmp_path / "m.npz")
    assert port_train.main([xml, str(tmp_path / "truth.bed"), model,
                            "--supervised", "--device", "cpu"]) == 0
    scores = {}
    for dev in ("cuda", "cpu"):
        for chunk in ("300", "16384"):
            capsys.readouterr()
            before = dict(ck.LAUNCHES)
            assert port_eval.main([xml, model, str(tmp_path / "regions.bed"),
                                   "--chunk", chunk, "--device", dev]) == 0
            scores[dev, chunk] = float(capsys.readouterr().out.strip())
            ran = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
            if dev == "cuda":
                assert ran["fwd_piece_ops"] and ran["fwd_piece_compose"]
                assert ran["fwd_chunk"] == 0
            else:
                assert not any(ran.values())
    for chunk in ("300", "16384"):
        card, cpu = scores["cuda", chunk], scores["cpu", chunk]
        assert abs(card - cpu) <= 1e-5 * abs(cpu), (card, cpu)
