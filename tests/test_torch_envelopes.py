"""The port's routes to S = 1024 on the CPU: the plain scans, the pointer
Viterbi (uint16 pointers past 256 states) and the carried sweeps against
the JAX package's ``dp`` at S = 240, 300 and 512; ``"auto"`` on a
CUDA-typed device to the scan tile's 1024 states and the envelope item
past them; ``cuda_kernels.sweep_fits`` and the carried sweeps' choice of
kernel; the pass budgets of the E-step and the stitched decoders past
256 states; and the CLI's BED at S = 300 through the card's routes,
against the JAX CLI's.

Tolerances are those of tests/test_pallas.py and
tests/test_torch_scans.py: value rows, pointers and paths exact (every
Viterbi step is an exact max, add or subtract), alpha_hat, beta_hat and
the carried sweeps' rows 1e-5 absolute, cumulative normalizers 1e-4
absolute, logliks 1e-6 relative; E-step statistics cut into passes
within 1e-5 relative of one pass (float32 reassociation only)."""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tehmm_tpu.cli import eval as jax_eval  # noqa: E402
from tehmm_tpu.ops import dp as jdp  # noqa: E402
from tehmm_tpu_torch.cli import eval as port_eval  # noqa: E402
from tehmm_tpu_torch.cli import train as port_train  # noqa: E402
from tehmm_tpu_torch.models import hmm as thmm  # noqa: E402
from tehmm_tpu_torch.models import params as tparams  # noqa: E402
from tehmm_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from tehmm_tpu_torch.ops import dp as tdp  # noqa: E402
from tehmm_tpu_torch.ops import em as tem  # noqa: E402
from tehmm_tpu_torch.parallel import stitch as tstitch  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
CPU, CUDA = torch.device("cpu"), torch.device("cuda")
LENGTHS = [13, 10, 1, 0]


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(rng, make_hmm, S, zero_frac=0.0):
    ls, lt, _ = make_hmm(S, 2, 4, zero_trans_frac=zero_frac)
    L = LENGTHS[0]
    obs = (rng.randn(len(LENGTHS), L, S) * 2.0).astype(np.float32)
    init = rng.randn(len(LENGTHS), S).astype(np.float32)
    init -= init.max(axis=1, keepdims=True)
    return (ls.astype(np.float32), lt.astype(np.float32), obs,
            np.asarray(LENGTHS, np.int32), init)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", [240, 300, 512])
def test_plain_scans_match_jax_past_256_states(rng, make_hmm, S, zero_frac):
    ls, lt, obs, lens, _ = _setup(rng, make_hmm, S, zero_frac)
    j = [jnp.asarray(x) for x in (ls, lt, obs, lens)]
    j_ah, j_lc, j_ll = jdp.forward_scaled(*j)
    j_bh, j_ld = jdp.backward_scaled(*j[1:])
    ah, lc, ll = tdp.forward_scaled(_t(ls), _t(lt), _t(obs), _t(lens))
    bh, ld = tdp.backward_scaled(_t(lt), _t(obs), _t(lens))
    for got, want in ((ah, j_ah), (bh, j_bh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    for got, want in ((lc, j_lc), (ld, j_ld)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(ll.numpy(), np.asarray(j_ll), rtol=1e-6,
                               atol=1e-6)
    want_p, want_s = jdp.viterbi(*j)
    for path, score in (tdp.viterbi(_t(ls), _t(lt), _t(obs), _t(lens)),
                        tdp.viterbi_backpointers(_t(ls), _t(lt), _t(obs),
                                                 _t(lens))):
        np.testing.assert_array_equal(path.numpy(), np.asarray(want_p))
        np.testing.assert_allclose(score.numpy(), np.asarray(want_s),
                                   rtol=1e-5, atol=1e-4)
    ptrs, _v, _dm = ck.viterbi_pointers_plain(_t(ls), _t(lt), _t(obs),
                                              _t(lens))
    assert ptrs.dtype == (torch.uint8 if S <= 256 else torch.uint16)


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
@pytest.mark.parametrize("S", [240, 300, 512])
def test_carried_sweeps_match_jax_past_256_states(rng, make_hmm, S,
                                                  zero_frac):
    """viterbi_carry / viterbi_chunk_values exact; forward_final,
    forward_chunk_values and backward_chunk_values within 1e-5 of the
    JAX package's (the plain versions the tile's carry modes are held to
    on the card)."""
    _, lt, obs, lens, init = _setup(rng, make_hmm, S, zero_frac)
    cont = np.asarray([True, False, True, False])
    j = dict(lt=jnp.asarray(lt), obs=jnp.asarray(obs),
             init=jnp.asarray(init), lens=jnp.asarray(lens))
    t = (_t(lt), _t(obs), _t(init), _t(lens))
    np.testing.assert_array_equal(
        tdp.viterbi_carry(*t).numpy(),
        np.asarray(jdp.viterbi_carry(j["lt"], j["obs"], j["init"],
                                     j["lens"])))
    np.testing.assert_array_equal(
        tdp.viterbi_chunk_values(*t).numpy(),
        np.asarray(jdp.viterbi_chunk_values(j["lt"], j["obs"], j["init"],
                                            j["lens"])))
    want_c, want_dm = jdp.forward_final(j["lt"], j["obs"], j["init"],
                                        j["lens"])
    got_c, got_dm = tdp.forward_final(*t)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_dm.numpy(), want_dm, rtol=1e-6,
                               atol=1e-6)
    want_h, _ = jdp.forward_chunk_values(j["lt"], j["obs"], j["init"],
                                         j["lens"])
    got_h, got_f = tdp.forward_chunk_values(*t)
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=0, atol=1e-5)
    assert torch.equal(got_f, got_c)
    want_b, want_x = jdp.backward_chunk_values(
        j["lt"], j["obs"], j["init"], jnp.asarray(cont), j["lens"])
    got_b, got_x = tdp.backward_chunk_values(_t(lt), _t(obs), _t(init),
                                             _t(cont), _t(lens))
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("S,dtype", [(256, torch.uint8),
                                     (257, torch.uint16),
                                     (1024, torch.uint16)])
def test_pointer_type_and_chase(rng, S, dtype):
    """uint8 pointers hold every state to 256, uint16 beyond; the chase
    walks either (states past 255 included)."""
    assert ck.pointer_dtype(S) == dtype
    L = 6
    ptrs = torch.from_numpy(rng.randint(0, S, size=(2, L, S))).to(dtype)
    v_last = torch.from_numpy(rng.randn(2, S).astype(np.float32))
    v_last[0, S - 1] = 10.0
    lens = torch.tensor([L, 0], dtype=torch.int32)
    path = ck.pointer_chase(ptrs, v_last, lens)
    assert path[0, L - 1] == S - 1 and bool((path[1] == 0).all())
    for t in range(L - 1, 0, -1):
        assert path[0, t - 1] == int(ptrs[0, t, int(path[0, t])])


@pytest.mark.parametrize("S,want", [(300, "cuda_v3"), (1024, "cuda_v3"),
                                    (1025, None)])
def test_auto_on_the_card_to_1024_states(S, want):
    """``"auto"`` on a CUDA-typed device (nothing runs on it) takes
    ``cuda_v3`` past K1 up to the scan tile's 1024 states and raises the
    tile's envelope item beyond; never ``"plain"``; off the card it is
    ``"plain"`` at every S."""
    assert tem.resolve_engine("auto", S, 5, 9, 0, CPU) == "plain"
    if want:
        assert tem.resolve_engine("auto", S, 5, 9, 0, CUDA) == want
    else:
        with pytest.raises(NotImplementedError, match="tile beyond 1024"):
            tem.resolve_engine("auto", S, 5, 9, 0, CUDA)


@pytest.mark.parametrize("S", [239, 240, 1024])
def test_sweep_fits_and_the_wrappers_choice(monkeypatch, S):
    """``sweep_fits`` is 4 (S^2 + 4 S) <= 232,448 bytes, so S <= 239; on
    the card the carried sweeps' wrappers launch their one-warp kernel
    where it holds and the tile's carry mode beyond, each under its own
    counter (the launch itself faked here: no card)."""
    assert ck.sweep_fits(S) == (S <= 239)
    assert ck.sweep_fits(S) == (4 * (S * S + 4 * S) <= 232448)
    launched = []
    monkeypatch.setattr(ck, "_device_kind", lambda dev: "cuda")
    monkeypatch.setattr(ck, "_launch_streaming",
                        lambda name, entry, args, dev:
                        launched.append((name, entry)))
    B, L = 2, 3
    lt = torch.zeros((S, S))
    obs = torch.zeros((B, L, S))
    carry = torch.zeros((B, S))
    lens = torch.full((B,), L, dtype=torch.int32)
    ck.viterbi_chunk_values(lt, obs, carry, lens)
    ck.viterbi_carry(lt, obs, carry, lens)
    ck.forward_chunk_values(lt, obs, carry, lens)
    ck.forward_final(lt, obs, carry, lens)
    ck.backward_chunk_values(lt, obs, carry,
                             torch.zeros(B, dtype=torch.bool), lens)
    if S <= 239:
        k3 = {"lanes": "tehmm_viterbi_sweep_lanes",
              "shared": "tehmm_viterbi_sweep_smem"}[ck.k3_step(S)]
        x1 = {"lanes": "tehmm_x1_sweep_lanes",
              "shared": "tehmm_x1_sweep_smem"}[ck.x1_step(S)]
        x2 = {"lanes": "tehmm_x2_sweep_lanes",
              "shared": "tehmm_x2_sweep_smem"}[ck.x2_step(S)]
        want = [("viterbi_chunk_values", k3)] * 2 \
            + [("fwd_chunk", x1)] * 2 \
            + [("bwd_chunk", x2)]
    else:   # K3's, X1's and X2's past 256 states on the cluster tile,
        # to 256 on the rows kernels
        rows = "_cluster" if S > 256 else "_rows"
        want = [("viterbi_chunk" + rows, "tehmm_viterbi_carry_tile")] * 2 \
            + [("fwd_chunk" + rows, "tehmm_fwd_chunk_tile")] * 2 \
            + [("bwd_chunk" + rows, "tehmm_bwd_chunk_tile")]
    assert launched == want


@pytest.mark.parametrize("S,budget,rows", [(256, 4 << 20, 512),
                                           (512, 2 << 20, 256),
                                           (1024, 1 << 20, 128)])
def test_pass_budgets_scale_past_256_states(S, budget, rows):
    """Past 256 states the E-step's positions a pass and the stitched
    decoders' rows a pass scale by 256 / S (at least one), on and off
    the card, so no [B, L, S] tensor of a pass grows past S = 256's."""
    params = tparams.from_numpy(np.zeros(S, np.float32),
                                np.zeros((S, S), np.float32),
                                np.zeros((S, 5, 9), np.float32), "cpu")
    for dev in (CPU, CUDA):
        assert thmm._pass_positions(params, None, dev) == budget
    assert tstitch.scaled_rows(512, S) == rows
    assert tstitch.scaled_rows(64, S) == rows // 8
    assert tstitch.scaled_rows(1, 4096) == 1


@pytest.mark.parametrize("decoder", ["viterbi", "maxpost"])
def test_decoders_take_the_scaled_rows(monkeypatch, decoder):
    """The stitched decoders' passes hold ``scaled_rows(rows_per_pass,
    S)`` rows (the decode itself faked: the rows a pass are the point)."""
    S, n, L = 1024, 300, 4
    params = tparams.from_numpy(np.zeros(S, np.float32),
                                np.zeros((S, S), np.float32),
                                np.zeros((S, 2, 3), np.float32), "cpu")
    seen = []

    def fake_paths(*a):
        sym = a[3]
        seen.append(sym.shape[0])
        return torch.zeros(sym.shape[:2], dtype=torch.int32), None

    def fake_scan(log_start, log_trans, obs, lens):
        seen.append(obs.shape[0])
        return torch.zeros_like(obs), None, None

    monkeypatch.setattr(ck, "viterbi_fused", fake_paths)
    monkeypatch.setattr(ck, "forward_scaled", fake_scan)
    monkeypatch.setattr(ck, "backward_scaled",
                        lambda lt, obs, lens: (torch.zeros_like(obs), None))
    sym = np.ones((n, L, 2), np.uint8)
    lens = np.full(n, L, np.int64)
    if decoder == "viterbi":
        tstitch._decode_batch(params, sym, lens, 512)
        assert seen == [128, 128, 44]
    else:
        tstitch._posterior_batch(params, sym, lens, 64)
        assert seen == [16] * 18 + [12]


def test_estep_passes_sum_to_one_pass(rng, make_hmm):
    """Cutting an E-step into passes moves its statistics only by float32
    reassociation: two passes' sums within 1e-5 relative of one."""
    S, T, V = 300, 2, 4
    ls, lt, le = (x.astype(np.float32) for x in make_hmm(S, T, V))
    params = tparams.from_numpy(ls, lt, le, "cpu")
    sym = torch.from_numpy(rng.randint(0, V, size=(4, 9, T)).astype(
        np.int32))
    lens = torch.tensor([9, 7, 9, 3], dtype=torch.int32)
    whole = tem.em_sufficient_stats(params, sym, lens)
    a = tem.em_sufficient_stats(params, sym[:2], lens[:2])
    b = tem.em_sufficient_stats(params, sym[2:], lens[2:])
    for name in ("start", "trans", "em", "loglik"):
        torch.testing.assert_close(getattr(a, name) + getattr(b, name),
                                   getattr(whole, name), rtol=1e-5,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def wide_model(tmp_path_factory):
    """A copy of tests/data with a 300-state model trained by the port
    (one EM iteration from its random start)."""
    work = tmp_path_factory.mktemp("envelopes_cli")
    for f in os.listdir(DATA):
        src = os.path.join(DATA, f)
        if os.path.isfile(src):
            shutil.copy(src, work / f)
    assert port_train.main([str(work / "tracks.xml"),
                            str(work / "regions.bed"), str(work / "m.npz"),
                            "--numStates", "300", "--iter", "1", "--seed",
                            "3", "--device", "cpu"]) == 0
    return work


@pytest.fixture
def card_routes(monkeypatch):
    """K2 and K4 say no (as at S = 300 on the card), and the Viterbi
    route is chosen as for a card; the routes' entry points count their
    calls."""
    monkeypatch.setattr(ck, "k2_fits", lambda *a: False)
    monkeypatch.setattr(ck, "k4_fits", lambda *a: False)
    route = tstitch.viterbi_route
    monkeypatch.setattr(tstitch, "viterbi_route",
                        lambda S, T, V, G, device: route(S, T, V, G, CUDA))
    calls = {"viterbi_streaming": 0, "forward_scaled": 0,
             "viterbi_fused": 0, "viterbi_chunk_values": 0,
             "posterior_decode_fused": 0}
    for owner, name in ((tdp, "viterbi_streaming"), (ck, "forward_scaled"),
                        (ck, "viterbi_fused"), (ck, "viterbi_chunk_values"),
                        (ck, "posterior_decode_fused")):
        fn = getattr(owner, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(owner, name, counted)
    return calls


@pytest.mark.parametrize("flags,route", [
    (["--no-exact", "--chunk", "700", "--halo", "32"], "viterbi_streaming"),
    (["--exact", "--chunk", "700"], "viterbi_chunk_values"),
    (["--no-exact", "--maxPost", "--chunk", "700", "--halo", "32"],
     "forward_scaled"),
])
def test_cli_bed_at_300_states_matches_the_jax_cli(wide_model, capsys,
                                                   card_routes, flags,
                                                   route):
    """``eval --bed`` at S = 300, stitched and ``--exact``, and
    ``--maxPost``, through the card's routes, write the JAX CLI's BED byte
    for byte and its score within 1e-5 relative."""
    out, scores = {}, {}
    work = wide_model
    for name, cli in (("jax", jax_eval), ("port", port_eval)):
        path = str(work / f"wide_{name}.bed")
        argv = [str(work / "tracks.xml"), str(work / "m.npz"),
                str(work / "regions.bed"), "--bed", path, *flags]
        capsys.readouterr()
        assert cli.main(argv + (["--device", "cpu"] if name == "port"
                                else [])) == 0
        scores[name] = float(capsys.readouterr().out.strip())
        out[name] = open(path, "rb").read()
    assert out["port"] == out["jax"] and out["port"]
    np.testing.assert_allclose(scores["port"], scores["jax"], rtol=1e-5)
    assert card_routes[route] >= 1
    assert not card_routes["viterbi_fused"]
    assert not card_routes["posterior_decode_fused"]
