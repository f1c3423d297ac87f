"""The exact Viterbi's backtrace from first-hit pointers against the JAX
package: K3's pointer mode (its plain version, which the CPU takes),
walked from every end state, is the JAX ``dp.viterbi_backtrace_chunk``
on the JAX value rows; X3's map, compose and chase over several chunks
are the JAX ``viterbi_exact``; the wrappers' route on the card with
launches faked.  The tables are small integers, so the candidates of a
step tie often and the first-hit rule (the lowest index) decides."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.models.params import HmmParams  # noqa: E402
from tehmm_tpu.ops import dp as jdp  # noqa: E402
from tehmm_tpu.parallel import stitch as jstitch  # noqa: E402
from tehmm_tpu_torch.models.params import from_numpy  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.parallel import stitch as tstitch  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_launches():
    ck.reset_launch_counts()
    yield
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES


def _tied(rng, S, B, L):
    """Integer-valued log transitions, obs and carry; lengths ragged with
    0, 1 and L among them."""
    log_trans = -rng.randint(0, 3, size=(S, S)).astype(np.float32)
    obs = -rng.randint(0, 4, size=(B, L, S)).astype(np.float32)
    init = -rng.randint(0, 3, size=(B, S)).astype(np.float32)
    lengths = rng.randint(0, L + 1, size=B).astype(np.int32)
    lengths[:3] = [0, 1, L]
    return log_trans, obs, init, lengths


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("S,L", [(1, 9), (2, 17), (4, 23), (7, 31)])
def test_pointers_chased_from_every_end_state_equal_jax(rng, S, L):
    """For every end state s: the chase of the plain pointers from s is
    the JAX backtrace's path from s, and the map's state for s is its
    entry state, with ragged lengths (0, 1, a part, the whole chunk)."""
    B = 6
    lt, obs, init, lengths = _tied(rng, S, B, L)
    v_hats = jdp.viterbi_chunk_values(jnp.asarray(lt), jnp.asarray(obs),
                                      jnp.asarray(init),
                                      jnp.asarray(lengths))
    ptrs = ck.viterbi_chunk_pointers(*_t(lt, obs, init, lengths))
    assert ptrs.dtype == torch.uint8 and tuple(ptrs.shape) == (B, L, S)
    lens = torch.from_numpy(lengths)
    maps = ck.chunk_entry_map(ptrs, lens)
    assert maps.dtype == torch.int32 and tuple(maps.shape) == (B, S)
    for s in range(S):
        end = np.full(B, s, np.int32)
        want_path, want_entry = jdp.viterbi_backtrace_chunk(
            jnp.asarray(lt), v_hats, jnp.asarray(init), jnp.asarray(end),
            jnp.asarray(lengths))
        path = ck.chunk_chase(ptrs, torch.from_numpy(end), lens)
        np.testing.assert_array_equal(path.numpy(), np.asarray(want_path))
        np.testing.assert_array_equal(maps[:, s].numpy(),
                                      np.asarray(want_entry))


def test_pointers_are_the_identity_past_each_length(rng):
    S, B, L = 5, 6, 12
    lt, obs, init, lens = _tied(rng, S, B, L)
    ptrs = ck.viterbi_chunk_pointers(*_t(lt, obs, init, lens))
    ident = np.arange(S, dtype=np.uint8)
    for b in range(B):
        for t in range(lens[b], L):
            np.testing.assert_array_equal(ptrs[b, t].numpy(), ident)


def test_compose_walks_the_maps_from_the_last_chunk(rng):
    """ends[:, n-1] is the given end state, ends[:, c-1] the map of chunk
    c at ends[:, c], and the entry the first chunk's map at its end."""
    B, n, S = 3, 5, 4
    maps = rng.randint(0, S, size=(B, n, S)).astype(np.int32)
    end = rng.randint(0, S, size=B).astype(np.int32)
    ends, entry = ck.chunk_compose(*_t(maps, end))
    for b in range(B):
        e = end[b]
        for c in reversed(range(n)):
            assert ends[b, c] == e
            e = maps[b, c, e]
        assert entry[b] == e
    ends0, entry0 = ck.chunk_compose(
        torch.zeros((B, 0, S), dtype=torch.int32), torch.from_numpy(end))
    assert tuple(ends0.shape) == (B, 0)
    assert torch.equal(entry0, torch.from_numpy(end))


@pytest.mark.parametrize("n_chunks", [1, 3, 6])
def test_map_compose_chase_over_chunks_equal_jax_backtraces(rng,
                                                             n_chunks):
    """One table cut into chunks, each from its own carry: the maps
    composed from the last chunk's end state, then every chunk chased in
    one call, give the JAX backtrace run chunk by chunk in reverse."""
    S, Lc = 5, 13
    lt, obs, _, _ = _tied(rng, S, 3, Lc * n_chunks)
    init = -rng.randint(0, 3, size=(n_chunks, S)).astype(np.float32)
    obs = obs[0].reshape(n_chunks, Lc, S)
    lengths = np.full(n_chunks, Lc, np.int32)
    lengths[-1] = Lc - 4               # the table ends inside its last chunk
    end = np.int32(rng.randint(S))
    # the JAX package's way: a chunk at a time, its entry state the next
    # chunk's end state
    want, state = [], jnp.asarray([end])
    for c in reversed(range(n_chunks)):
        v = jdp.viterbi_chunk_values(
            jnp.asarray(lt), jnp.asarray(obs[c:c + 1]),
            jnp.asarray(init[c:c + 1]), jnp.asarray(lengths[c:c + 1]))
        path, state = jdp.viterbi_backtrace_chunk(
            jnp.asarray(lt), v, jnp.asarray(init[c:c + 1]), state,
            jnp.asarray(lengths[c:c + 1]))
        want.append(np.asarray(path)[0])
    want = np.concatenate(want[::-1])
    lt_t, obs_t, init_t, lens_t = _t(lt, obs, init, lengths)
    ptrs = ck.viterbi_chunk_pointers(lt_t, obs_t, init_t, lens_t)
    maps = ck.chunk_entry_map(ptrs, lens_t)
    ends, entry = ck.chunk_compose(maps[None],
                                   torch.tensor([end], dtype=torch.int32))
    got = ck.chunk_chase(ptrs, ends[0].contiguous(), lens_t).reshape(-1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(entry[0]) == int(np.asarray(state)[0])


def _tied_model(rng, S, T, V):
    """A model of small integer log tables (many exact ties)."""
    start = -rng.randint(0, 2, size=S).astype(np.float32)
    trans = -rng.randint(0, 2, size=(S, S)).astype(np.float32)
    em = -rng.randint(0, 3, size=(S, T, V)).astype(np.float32)
    return start, trans, em


@pytest.mark.parametrize("per", [1, 2, 4])
def test_exact_with_ties_equals_jax(rng, monkeypatch, per):
    """The grouped exact decode (pointers, maps, compose, chase) on a model
    whose every step ties gives the JAX ``viterbi_exact``'s paths byte
    for byte, at groups of 1, 2 and all 4 chunks."""
    S, T, V, CHUNK = 4, 2, 3, 29
    tables = _tied_model(rng, S, T, V)
    jp = HmmParams(*(jnp.asarray(x) for x in tables))
    tp = from_numpy(*tables, CPU)
    syms = [rng.randint(0, V, size=(n, T)).astype(np.uint8)
            for n in (117, 0, 1, 30, 59)]
    monkeypatch.setattr(tstitch, "EXACT_GROUP_BYTES",
                        per * 2 * 4 * len(syms) * CHUNK * S)
    assert tstitch.exact_group_chunks(len(syms), CHUNK, S) == per
    want = jstitch.viterbi_exact(jp, syms, chunk_len=CHUNK)
    got = tstitch.viterbi_exact(tp, syms, chunk_len=CHUNK)
    for w, g in zip(want, got):
        assert np.asarray(w).tobytes() == g.tobytes()


# ---------------------------------------------------------------------
# the route on the card, launches faked
# ---------------------------------------------------------------------

def _fake_card(monkeypatch):
    launched = []
    monkeypatch.setattr(ck, "_device_kind", lambda dev: "cuda")
    monkeypatch.setattr(ck, "_launch_streaming",
                        lambda name, entry, args, dev:
                        launched.append((name, entry, args[-3:])))
    return launched


@pytest.mark.parametrize("S", [1, 10, 32, 33, 239, 240])
def test_pointer_mode_by_states(monkeypatch, S):
    """The pointer mode takes K3's step by S (lanes to 32 states, shared
    to 239) under its own counter; the tile has no pointer mode and
    raises naming its item."""
    launched = _fake_card(monkeypatch)
    B, L = 3, 10
    args = (torch.zeros((S, S)), torch.zeros((B, L, S)),
            torch.zeros((B, S)), torch.full((B,), L, dtype=torch.int32))
    if ck.k3_step(S) == "tile":
        with pytest.raises(NotImplementedError,
                           match="K3's pointer mode on the tile"):
            ck.viterbi_chunk_pointers(*args)
        assert launched == []
        return
    out = ck.viterbi_chunk_pointers(*args)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (B, L, S)
    entry = {"lanes": "tehmm_viterbi_pointers_lanes",
             "shared": "tehmm_viterbi_pointers_smem"}[ck.k3_step(S)]
    assert launched == [("viterbi_chunk_pointers", entry, (B, L, S))]


def test_x3_launches_and_checks(monkeypatch):
    """Map, compose and chase each launch once under their counters; the
    map takes 16-byte aligned pointers only, the compose and the chase
    end states in [0, S)."""
    launched = _fake_card(monkeypatch)
    R, L, S = 4, 6, 10
    ptrs = torch.zeros((R, L, S), dtype=torch.uint8)
    lens = torch.full((R,), L, dtype=torch.int32)
    ends = torch.zeros((R,), dtype=torch.int32)
    ck.chunk_entry_map(ptrs, lens)
    ck.chunk_compose(torch.zeros((2, 2, S), dtype=torch.int32), ends[:2])
    ck.chunk_chase(ptrs, ends, lens)
    assert [x[:2] for x in launched] == [
        ("chunk_entry_map", "tehmm_chunk_entry_map"),
        ("chunk_compose", "tehmm_chunk_compose"),
        ("chunk_chase", "tehmm_chunk_chase")]
    flat = torch.zeros(R * L * S + 16, dtype=torch.uint8)
    odd = flat[1:1 + R * L * S].view(R, L, S)
    if odd.data_ptr() % 16:
        with pytest.raises(ValueError, match="16-byte aligned"):
            ck.chunk_entry_map(odd, lens)
    with pytest.raises(ValueError, match="end_state"):
        ck.chunk_chase(ptrs, ends + S, lens)
    with pytest.raises(TypeError, match="ptrs"):
        ck.chunk_entry_map(ptrs.to(torch.int32), lens)
