"""K3's pointer mode and X3 (the exact decoder's backtrace from its
pointers) against their plain versions, on the card.

Every one is exact: pointers, maps, end states and paths must equal the
plain versions' bit for bit.  The tables are small integers, so the
candidates of a step tie often and the first-hit rule (the lowest index)
is what decides; lengths are ragged (0, 1, the whole row) and rows of
L x S bytes sit at every alignment, so the staged windows start and end
off 16-byte boundaries.  K3's pointer mode runs under both steps: the
lanes step to 32 states, the shared step from 33 and, forced with
``ck.K3_LANES_MAX_STATES`` = 0, below."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

pytestmark = pytest.mark.cuda

STATES = [1, 2, 10, 16, 31, 32, 33, 64, 239]
# (rows, positions): one row past several windows at every S (a window
# holds 16384 // S positions), a few rows, a recompute group of rows
SHAPES = [(1, 1700), (3, 70), (37, 300)]
STEPS = [(S, "lanes") for S in STATES if S <= 32] + \
    [(S, "shared") for S in STATES]


def _inputs(S, B, L, seed):
    """Integer-valued log tables and obs (ties at most steps), a carry,
    ragged lengths."""
    rng = np.random.RandomState(seed)
    log_trans = -rng.randint(0, 3, size=(S, S)).astype(np.float32)
    obs = -rng.randint(0, 4, size=(B, L, S)).astype(np.float32)
    init = -rng.randint(0, 3, size=(B, S)).astype(np.float32)
    lengths = rng.randint(0, L + 1, size=B).astype(np.int32)
    lengths[:3] = [L, 0, 1][:B]
    return (torch.from_numpy(log_trans), torch.from_numpy(obs),
            torch.from_numpy(init), torch.from_numpy(lengths))


def _on(device, tensors):
    return tuple(t.to(device) for t in tensors)


@pytest.mark.parametrize("B,L", SHAPES)
@pytest.mark.parametrize("S,step", STEPS)
def test_pointer_mode_bit_equal(device, monkeypatch, S, step, B, L):
    """K3's pointer mode equals its plain version at every position and
    state, and launches once under its counter."""
    if step == "shared":
        monkeypatch.setattr(ck, "K3_LANES_MAX_STATES", 0)
    assert ck.k3_step(S) == step
    args = _on(device, _inputs(S, B, L, S * 100 + B))
    before = dict(ck.LAUNCHES)
    got = ck.viterbi_chunk_pointers(*args)
    want = ck.viterbi_chunk_pointers_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.shape == (B, L, S)
    assert torch.equal(got, want)
    assert ck.LAUNCHES["viterbi_chunk_pointers"] == \
        before["viterbi_chunk_pointers"] + 1
    assert ck.LAUNCHES["viterbi_chunk_values"] == \
        before["viterbi_chunk_values"]


@pytest.mark.parametrize("B,L", SHAPES)
@pytest.mark.parametrize("S", STATES)
@pytest.mark.parametrize("source", ["k3", "random"])
def test_map_compose_chase_bit_equal(device, S, B, L, source):
    """The map, the compose and the chase equal their plain versions, on
    K3's pointers and on random ones (whose padding is no identity, so
    the held state past a row's length is the kernels' own rule)."""
    lt, obs, init, lens = _inputs(S, B, L, S * 100 + B + 7)
    if source == "k3":
        ptrs = ck.viterbi_chunk_pointers_plain(lt, obs, init, lens)
    else:
        ptrs = torch.from_numpy(np.random.RandomState(S + B).randint(
            0, S, size=(B, L, S)).astype(np.uint8))
    ends = torch.from_numpy(np.random.RandomState(S).randint(
        0, S, size=B).astype(np.int32))
    want_map = ck.chunk_entry_map_plain(ptrs, lens)
    want_ends, want_entry = ck.chunk_compose_plain(want_map[None], ends[:1])
    want_path = ck.chunk_chase_plain(ptrs, ends, lens)
    ptrs, lens, ends = _on(device, (ptrs, lens, ends))
    before = dict(ck.LAUNCHES)
    got_map = ck.chunk_entry_map(ptrs, lens)
    got_ends, got_entry = ck.chunk_compose(got_map[None], ends[:1])
    got_path = ck.chunk_chase(ptrs, ends, lens)
    torch.cuda.synchronize()
    assert torch.equal(got_map.cpu(), want_map)
    assert torch.equal(got_ends.cpu(), want_ends)
    assert torch.equal(got_entry.cpu(), want_entry)
    assert torch.equal(got_path.cpu(), want_path)
    for name in ("chunk_entry_map", "chunk_compose", "chunk_chase"):
        assert ck.LAUNCHES[name] == before[name] + 1


def test_chase_from_the_map_is_the_entry(device):
    """Chasing a row from end state s reaches, one step before position
    0, the map's state for s: the path's first state is where the walk
    stands before its last lookup."""
    S, B, L = 10, 5, 700
    lt, obs, init, lens = _on(device, _inputs(S, B, L, 3))
    lens = torch.full_like(lens, L)
    ptrs = ck.viterbi_chunk_pointers(lt, obs, init, lens)
    maps = ck.chunk_entry_map(ptrs, lens)
    for s in range(S):
        ends = torch.full((B,), s, dtype=torch.int32, device=device)
        path = ck.chunk_chase(ptrs, ends, lens).long()
        first = ptrs[:, 0].long().gather(1, path[:, :1])[:, 0]
        assert torch.equal(first.int(), maps[:, s])


def test_misaligned_pointers_and_the_tile_raise(device):
    S, R, L = 10, 2, 5
    lens = torch.full((R,), L, dtype=torch.int32, device=device)
    flat = torch.zeros(R * L * S + 1, dtype=torch.uint8, device=device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ck.chunk_entry_map(flat[1:].view(R, L, S), lens)
    lt, obs, init, lens = _on(device, _inputs(240, 2, 4, 0))
    with pytest.raises(NotImplementedError, match="pointer mode"):
        ck.viterbi_chunk_pointers(lt, obs, init, lens)
