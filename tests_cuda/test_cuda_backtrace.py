"""The value-row backtrace (``ck.viterbi_backtrace``) against its plain
version, ``dp.viterbi_backtrace_chunk``, on the card.

The kernel gives a row a warp and takes each step's first-hit argmax
across the lanes; every candidate is the plain version's float add, so
paths and entry states are bit-equal, ties included (the lowest index
wins, as ``torch.argmax``'s).  The cases reach trans^T in shared
memory to 236 states (a lane's states l + 32 k, one to eight) and read
from L2 from 237 (its quads 4 l + 128 k + e, two to eight, partial where
S is no multiple of 4), a block's rows from 1 to past one wave of the
card, ragged lengths (0, 1, L and past L), the strided slices
``viterbi_streaming`` passes, rows copied 16 bytes or 4 bytes at a time
(aligned or not), ties (uniform transitions, constant rows, small
integers), zero-transition columns (LOG_ZERO and -inf) and an end state
of S - 1."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

pytestmark = pytest.mark.cuda

# trans^T staged in shared memory to 236 states (beside one warp's ring
# of two positions; 1, 2, 4 or 8 states a lane), read from L2 from 237
# (2, 4 or 8 quads a lane)
STATES = [1, 2, 3, 5, 31, 32, 33, 64, 65, 127, 128, 129, 235, 236, 237,
          256, 257, 512, 1000, 1023, 1024]
KINDS = ["random", "ties", "uniform", "zero_columns"]


def _inputs(rng, device, S, B, L, kind):
    """(log_trans [S, S], v [B, L + 1, S], end_state, lengths): the
    value rows at positions -1..L-1 of each row in one tensor, so that
    ``v[:, 1:]`` and ``v[:, 0]`` are the strided slices
    ``dp.viterbi_streaming`` passes; lengths cycle through 0, 1, L, past
    L and random."""
    if kind == "random":
        lt = rng.randn(S, S)
        v = rng.randn(B, L + 1, S)
    elif kind == "ties":
        lt = -rng.randint(0, 3, size=(S, S))
        v = -rng.randint(0, 3, size=(B, L + 1, S))
    elif kind == "uniform":
        lt = np.full((S, S), -np.log(S))
        v = np.zeros((B, L + 1, S))
    else:  # columns of LOG_ZERO and of -inf (a zero transition into j)
        lt = rng.randn(S, S)
        cols = rng.rand(S)
        lt[:, cols < 0.25] = -1e30
        lt[:, (cols >= 0.25) & (cols < 0.5)] = -np.inf
        v = rng.randn(B, L + 1, S)
    lens = np.resize(np.array([L, 0, 1, L + 3, L - 1 if L > 1 else 1]), B)
    lens = np.where(np.arange(B) >= 5, rng.randint(0, L + 1, size=B), lens)
    end = rng.randint(0, S, size=B)
    end[0] = S - 1
    return (torch.from_numpy(lt.astype(np.float32)).to(device),
            torch.from_numpy(v.astype(np.float32)).to(device),
            torch.from_numpy(end.astype(np.int32)).to(device),
            torch.from_numpy(lens.astype(np.int32)).to(device))


def _check(lt, v, end, lens):
    """One launch, bit-equal to plain on the strided slices."""
    before = ck.LAUNCHES["viterbi_backtrace"]
    path, entry = ck.viterbi_backtrace(lt, v[:, 1:], v[:, 0], end, lens)
    assert ck.LAUNCHES["viterbi_backtrace"] == before + 1
    want = ck.viterbi_backtrace_plain(lt, v[:, 1:].contiguous(),
                                      v[:, 0].contiguous(), end, lens)
    assert torch.equal(path, want[0])
    assert torch.equal(entry, want[1])
    return path, entry


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("S", STATES)
def test_backtrace_bit_equal(device, rng, S, kind):
    lt, v, end, lens = _inputs(rng, device, S, 7, 37, kind)
    path, _entry = _check(lt, v, end, lens)
    # past a row's length the end state holds
    for b in range(7):
        n = min(int(lens[b]), 37)
        assert bool((path[b, max(n - 1, 0):] == end[b]).all())


@pytest.mark.parametrize("S", [1, 33, 236, 237, 1024])
@pytest.mark.parametrize("L", [1, 2, 33, 64])
def test_backtrace_short_rows(device, rng, S, L):
    """One row and a few, rows of one position to two groups of 32 (the
    path's stores go out a group at a time)."""
    for B in (1, 3):
        _check(*_inputs(rng, device, S, B, L, "ties"))


@pytest.mark.parametrize("S,B", [(5, 9000), (64, 2200), (237, 2000),
                                 (1024, 2000)])
def test_backtrace_past_one_wave(device, rng, S, B):
    """More rows than the card holds at once (16 rows a block at most;
    at S = 1024 a block's rings fill shared memory at 14)."""
    _check(*_inputs(rng, device, S, B, 5, "ties"))


@pytest.mark.parametrize("S", [20, 236, 1024])
def test_backtrace_unaligned_rows(device, rng, S):
    """Rows that start off a 16-byte boundary (S a multiple of 4): the
    ring takes them 4 bytes at a time, with the same bits."""
    lt, v, end, lens = _inputs(rng, device, S, 6, 21, "ties")
    flat = torch.empty(v.numel() + 1, dtype=v.dtype, device=device)
    shifted = flat[1:].view(v.shape)
    shifted.copy_(v)
    _check(lt, shifted, end, lens)


def test_backtrace_uniform_takes_state_zero(device, rng):
    """Every candidate equal: each step takes state 0, as the serial
    first-hit scan does."""
    S, L = 70, 9
    lt, v, end, lens = _inputs(rng, device, S, 4, L, "uniform")
    lens = torch.full_like(lens, L)
    path, entry = _check(lt, v, end, lens)
    assert bool((path[:, : L - 1] == 0).all()) and bool((entry == 0).all())
    assert torch.equal(path[:, L - 1], end)
