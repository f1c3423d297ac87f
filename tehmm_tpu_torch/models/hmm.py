"""MultitrackHmm: the user-facing model API (training, Viterbi
decoding, persistence).

Counterpart of part of ``tehmm_tpu/models/hmm.py``: the constructors
(``initialized``, ``supervised``), Baum-Welch EM (``fit``, and
``fit_restarts`` for random restarts), Viterbi decoding
(``decode_tables``, ``decode_to_bed``), max-posterior decoding
(``posterior_decode_tables``), posterior distributions
(``posterior_distributions``), the data's log-likelihood (``score``),
``save`` and ``load``, plus the NumPy helpers ``path_log_score``,
``path_to_intervals``, ``label_tables`` and ``_labeled_runs`` (copied,
because the original module imports JAX).  Supervised counting stays
host-side, through the shared native counters.

EM stages the chunked training batch on the model's device (int32
symbols) once, or streams host pass-blocks when it exceeds the device
budget; on the card every E-step runs through K1.  The fit loop keeps
the reference's lagged convergence check, so both packages take the
same E/M steps and log the same logliks.

Gaussian tracks (``self.gauss``, ``models/gauss.py``) and segment
weights (``obs_weight_arrays`` / ``weight_arrays``, ``--segment
--segLen``) ride along every path: their values and weights are chunked
and staged beside the symbols, and on the card reach the kernels as
their optional streams.  The mesh and the train -> decode staging cache
are later slices of the port (ROADMAP, Queue 1).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import numpy as np
import torch

from tehmm_tpu_torch import native
from tehmm_tpu_torch.io.category import CategoryMap
from tehmm_tpu_torch.io.trackdata import TrackData, TrackTable
from tehmm_tpu_torch.io.trackxml import TrackList
from tehmm_tpu_torch.utils.common import EPSILON, JsonlMetrics, logger
from tehmm_tpu_torch.models.emission import obs_log_likelihoods
from tehmm_tpu_torch.models.gauss import (
    LOG_2PI,
    GaussParams,
    gauss_m_step,
    supervised_gauss,
)
from tehmm_tpu_torch.models import gauss as gauss_ops
from tehmm_tpu_torch.models.params import (
    HmmParams,
    init_flat,
    init_random,
    load_model,
    save_model,
)
from tehmm_tpu_torch.ops import cuda_kernels as ck
from tehmm_tpu_torch.ops import dp
from tehmm_tpu_torch.ops import em as em_ops
from tehmm_tpu_torch.parallel.chunking import batch_chunks, plan_chunks
from tehmm_tpu_torch.parallel.stitch import (
    StitchReport,
    _weight_batch,
    posterior_chunked,
    posterior_sweep,
    scaled_rows,
    viterbi_chunked,
)

_MESH_ITEM = "ROADMAP Queue 1, slice 6: sharding"

# E-step pass budget: positions per E-step call.  The plain, cuda_v3 and
# cuda_log E-steps hold several [B, L, S] tensors per pass (~400
# bytes/position at S=20); K1 holds only alpha_p, dm, m_raw and the
# symbols, so its passes can be much larger.  Module-level so tests and
# tight deployments can tune it.
_MAX_PASS_POSITIONS = 4 << 20
_MAX_PASS_POSITIONS_FUSED = 32 << 20


def _pass_positions(params: HmmParams, gauss: GaussParams | None,
                    device: torch.device) -> int:
    """Positions per E-step pass for the engine ``"auto"`` takes
    (``ops.em.resolve_engine``): K1's budget only where K1 runs, the
    [B, L, S] engines' budget otherwise, scaled by 256 / S past 256
    states (``scaled_rows``), so that no [B, L, S] tensor of a pass grows
    past what it holds at S = 256 (4 GB each at S = 1024 with the
    unscaled budget's 16 GB).  The E-step statistics are sums over
    passes: a smaller pass moves them only by float32 reassociation."""
    engine = em_ops.resolve_engine(
        "auto", *params.log_em.shape,
        0 if gauss is None else gauss.num_tracks, device)
    if engine == "cuda":
        return _MAX_PASS_POSITIONS_FUSED
    return scaled_rows(_MAX_PASS_POSITIONS, params.num_states)


def _env_int(name: str) -> int | None:
    """Integer env var accepting float forms ('40e9'); unset/empty ->
    None; anything else -> an error naming the variable."""
    v = os.environ.get(name, "").strip()
    if not v:
        return None
    try:
        return int(float(v))
    except ValueError:
        raise ValueError(
            f"{name}={v!r} is not a number (examples: 8589934592, 40e9)"
        ) from None


def _device_input_budget(device: torch.device) -> int:
    """Byte budget for staging the training inputs on ``device``:
    ``TEHMM_MAX_DEVICE_BYTES``, else 40% of the card's memory (the rest
    is the E-step's working set), else 6 GiB on the CPU.  Larger inputs
    train identically through host-streamed pass blocks."""
    env = _env_int("TEHMM_MAX_DEVICE_BYTES")
    if env is not None:
        return env
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total * 0.4)
    return 6 << 30


def _make_host_passes(arrays: tuple, rows_per_pass: int) -> list[tuple]:
    """Host (NumPy) pass blocks of ``rows_per_pass`` rows of each array
    (symbols, lengths, weights, values; None stays None) for inputs too
    large to stage: the last one zero-padded (padded rows have length
    0), uploaded one at a time by the fit loop."""
    n_rows = arrays[0].shape[0]
    rows_per_pass = min(rows_per_pass, n_rows)
    blocks = []
    for lo in range(0, n_rows, rows_per_pass):
        hi = min(lo + rows_per_pass, n_rows)
        pad = rows_per_pass - (hi - lo)
        blocks.append(tuple(
            None if a is None else a[lo:hi] if pad == 0 else
            np.concatenate(
                [a[lo:hi], np.zeros((pad,) + a.shape[1:], a.dtype)])
            for a in arrays
        ))
    return blocks


def _make_passes(arrays: tuple, rows_per_pass: int):
    """The staged batch (symbols, lengths, weights, values; None stays
    None) cut into pass blocks of ``rows_per_pass`` rows (zero-padded rows
    have length 0): a list of per-pass tuples, or None when one pass
    suffices."""
    n_rows = arrays[0].shape[0]
    if n_rows <= rows_per_pass:
        return None
    P = -(-n_rows // rows_per_pass)
    pad = P * rows_per_pass - n_rows

    def split(a):
        if a is None:
            return [None] * P
        a = torch.nn.functional.pad(a, (0, 0) * (a.dim() - 1) + (0, pad))
        return list(a.reshape(P, rows_per_pass, *a.shape[1:]))

    return list(zip(*(split(a) for a in arrays)))


def _to_device(a: np.ndarray | None, dtype, device: torch.device):
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def _train_arrays(tables, chunks, batch, gauss: bool,
                  obs_weight_arrays) -> tuple:
    """The chunked training inputs on the host: (int32 symbols [rows, L,
    T], int32 lengths [rows], f32 weights [rows, L] or None, f32 values
    [rows, L, G] or None)."""
    w_np = gv_np = None
    if obs_weight_arrays is not None:
        w_np = _weight_batch(obs_weight_arrays, chunks)
    if gauss:
        gv_np = batch_chunks(
            [np.asarray(t.values, np.float32) for t in tables], chunks
        ).symbols
    return (np.ascontiguousarray(batch.symbols, np.int32),
            np.ascontiguousarray(batch.lengths, np.int32), w_np, gv_np)


def _stage(arrays: tuple, device: torch.device) -> tuple:
    """The host training inputs (``_train_arrays``) on ``device``."""
    sym, lens, w, gv = arrays
    return (_to_device(sym, np.int32, device),
            _to_device(lens, np.int32, device),
            _to_device(w, np.float32, device),
            _to_device(gv, np.float32, device))


@dataclasses.dataclass
class FitResult:
    logliks: list[float]
    iterations: int
    converged: bool
    wall_seconds: float


class MultitrackHmm:
    """Multi-track HMM with independent categorical emissions, and
    normal emissions for the tracks declared ``distribution="gaussian"``
    (``self.gauss``)."""

    def __init__(
        self,
        params: HmmParams,
        track_list: TrackList,
        category_maps: dict[str, CategoryMap],
        state_names: list[str] | None = None,
    ):
        self.params = params
        self.track_list = track_list
        self.category_maps = category_maps
        self.extra: dict = {}  # free-form persisted metadata (e.g. cfg)
        # gaussian-track normal emissions (models/gauss.GaussParams);
        # None when no track declares distribution="gaussian"
        self.gauss: GaussParams | None = None
        S = params.num_states
        self.state_names = state_names or [str(i) for i in range(S)]
        if len(self.state_names) != S:
            raise ValueError(
                f"{len(self.state_names)} state names for {S} states"
            )

    # ------------------------------------------------------------------
    @property
    def num_states(self) -> int:
        return self.params.num_states

    @property
    def alphabet_sizes(self) -> list[int]:
        return [len(self.category_maps[t.name]) for t in self.track_list]

    def state_index(self, name: str) -> int:
        return self.state_names.index(name)

    # ------------------------------------------------------------------
    @classmethod
    def initialized(
        cls,
        num_states: int,
        track_data: TrackData,
        device: str | torch.device,
        init: str = "flat",
        seed: int = 0,
        rand_range: tuple[float, float] = (0.1, 0.9),
        state_names: list[str] | None = None,
    ) -> "MultitrackHmm":
        """Fresh model over loaded track data (``--flatEm``, or random
        emissions from ``numpy.random.RandomState(seed)`` as in the JAX
        package).  Gaussian tracks get their parameters from
        ``models.gauss.init_gauss`` (the train CLI's ``_init_model``)."""
        sizes = track_data.alphabet_sizes
        if init == "flat":
            params = init_flat(num_states, sizes, device)
        elif init == "random":
            params = init_random(num_states, sizes, seed, device,
                                 rand_range)
        else:
            raise ValueError(f"unknown init {init!r}")
        return cls(params, track_data.track_list, track_data.category_maps,
                   state_names)

    @classmethod
    def supervised(
        cls,
        track_data: TrackData,
        labeled_intervals: Sequence[Sequence],
        device: str | torch.device,
        epsilon: float = EPSILON,
    ) -> "MultitrackHmm":
        """Supervised training: state = BED name column (reference:
        teHmmTrain.py --supervised -> hmm.supervisedTrain counting).

        ``labeled_intervals`` are (chrom, start, end, stateName) covering
        the loaded tables; state names are assigned indices in first-seen
        order.  Counting is host-side (float64); the M-step runs on
        ``device`` in float32.  Gaussian tracks get per-state moments of
        their labeled finite values (``models.gauss.supervised_gauss``).
        """
        state_names: list[str] = []
        name_to_idx: dict[str, int] = {}
        for iv in labeled_intervals:
            name = str(iv[3])
            if name not in name_to_idx:
                name_to_idx[name] = len(state_names)
                state_names.append(name)

        states_per_table = label_tables(
            track_data.tables, labeled_intervals, name_to_idx
        )
        S = len(state_names)
        sizes = track_data.alphabet_sizes
        V = max(sizes)
        T = track_data.num_tracks

        start_c = np.zeros(S, np.float64)
        trans_c = np.zeros((S, S), np.float64)
        em_c = np.zeros((S, T, V), np.float64)
        n_pos = 0
        for tab, states in zip(track_data.tables, states_per_table):
            # maximal labeled runs: transitions never count across
            # unlabeled gaps (each run is its own sequence)
            for s, e in _labeled_runs(states):
                st = states[s:e]
                sym = tab.symbols[s:e]
                n_pos += e - s
                start_c[st[0]] += 1
                tc = native.count_transitions(st, S)
                ec = native.count_emissions(st, sym, S, V)
                if tc is not None:
                    trans_c += tc
                    em_c += ec
                else:  # NumPy fallback (no compiler available)
                    np.add.at(trans_c, (st[:-1], st[1:]), 1)
                    for t in range(T):
                        np.add.at(
                            em_c, (st, t, sym[:, t].astype(np.int64)), 1
                        )
        if n_pos == 0:
            raise ValueError("no labeled positions found")

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        stats = em_ops.EmStats(
            start=f32(start_c), trans=f32(trans_c), em=f32(em_c),
            loglik=f32(0.0), n_obs=f32(float(n_pos)),
        )
        params = em_ops.em_m_step(stats, init_flat(S, sizes, device),
                                  sizes, epsilon=epsilon)
        model = cls(
            params, track_data.track_list, track_data.category_maps,
            state_names,
        )
        if track_data.gauss_track_indices:
            model.gauss = supervised_gauss(
                S, [t.values for t in track_data.tables], states_per_table,
                device,
            )
        return model

    # ------------------------------------------------------------------
    # unsupervised / semi-supervised EM
    # ------------------------------------------------------------------
    def fit(
        self,
        tables: Sequence[TrackTable],
        max_iterations: int = 100,
        convergence_tol: float = 1e-3,
        masks: em_ops.ParamMasks | None = None,
        epsilon: float = EPSILON,
        chunk_len: int = 1 << 14,
        metrics: JsonlMetrics | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 10,
        obs_weight_arrays: Sequence[np.ndarray] | None = None,
        device_loop: bool = False,
        max_device_bytes: int | None = None,
    ) -> FitResult:
        """Baum-Welch EM on the model's device.

        Tables are cut into independent chunks of ``chunk_len``.  The
        batch (symbols, and the segment weights ``obs_weight_arrays`` —
        per-table f32[L] — and gaussian values when there are any) is
        staged once (or, past ``max_device_bytes`` — default
        ``_device_input_budget`` — streamed as host pass blocks) and cut
        into pass blocks; each E-step sums the blocks' statistics.
        ``device_loop`` runs ``ops.em.em_run`` over the whole batch (no
        per-iteration logging or checkpoints).  Gaussian parameters take
        their M-step after the categorical one, with ``--fixEm``'s states
        frozen.

        Iteration i's loglik is logged and checked only after iteration
        i+1's E- and M-step, exactly as the JAX package's pipelined loop
        does, so the model returned has had one M-step more than its
        last logged loglik when EM converges."""
        device = self.params.device
        mats = [t.symbols for t in tables]
        chunks = plan_chunks([len(m) for m in mats], chunk_len, halo=0)
        batch = batch_chunks(mats, chunks)
        host = _train_arrays(tables, chunks, batch, self.gauss is not None,
                             obs_weight_arrays)
        sizes = self.alphabet_sizes
        n_rows, Lr = batch.symbols.shape[:2]
        n_positions = int(batch.lengths.sum())
        logliks: list[float] = []
        converged = False
        t0 = time.time()
        fix = masks.fix_em_states if masks is not None else None

        pass_positions = _pass_positions(self.params, self.gauss, device)
        rows_per_pass = max(1, pass_positions // max(Lr, 1))
        staged_bytes = sum(a.nbytes for a in host if a is not None) \
            - host[1].nbytes
        budget = (max_device_bytes if max_device_bytes is not None
                  else _device_input_budget(device))
        host_passes = passes = staged = None
        if not device_loop and staged_bytes > budget:
            bytes_per_row = max(1, staged_bytes // max(n_rows, 1))
            rows_per_pass = max(1, min(
                rows_per_pass, int(budget // (2 * bytes_per_row))))
            host_passes = _make_host_passes(host, rows_per_pass)
            logger.info(
                "training inputs (%.2f GB) exceed the device staging "
                "budget — streaming %d host pass-blocks per iteration",
                staged_bytes / 1e9, len(host_passes),
            )
        else:
            stage_t0 = time.time()
            staged = _stage(host, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            stage_dt = time.time() - stage_t0
            logger.info(
                "staged %.2f GB of training inputs in %.1fs (%.2f GB/s "
                "H2D)", staged_bytes / 1e9, stage_dt,
                staged_bytes / 1e9 / max(stage_dt, 1e-9),
            )
            if not device_loop:
                passes = _make_passes(staged, rows_per_pass)

        if device_loop:
            symbols, lengths, weights, values = staged
            out = em_ops.em_run(
                self.params, symbols, sizes, lengths,
                max_iterations=max_iterations,
                convergence_tol=convergence_tol, masks=masks,
                epsilon=epsilon, obs_weights=weights,
                gauss_params=self.gauss, gauss_values=values,
            )
            self.params, hist, n = out[:3]
            if self.gauss is not None:
                self.gauss = out[3]
            logliks = [float(x) for x in hist[:n].cpu()]
            wall = time.time() - t0
            logger.info(
                "EM device loop: %d iters in %.2fs (%.3g pos/s), final "
                "loglik %.4f", n, wall, n * n_positions / max(wall, 1e-9),
                logliks[-1] if logliks else float("nan"),
            )
            if metrics is not None:
                for i, ll in enumerate(logliks):
                    metrics.write(iter=i, loglik=ll)
            if checkpoint_path:
                self.save(checkpoint_path, extra={"iteration": n - 1})
            return FitResult(logliks=logliks, iterations=n,
                             converged=n < max_iterations,
                             wall_seconds=wall)

        def estep() -> em_ops.EmStats:
            if host_passes is not None:
                blocks = (_stage(blk, device) for blk in host_passes)
            elif passes is not None:
                blocks = passes
            else:
                blocks = [staged]
            stats = None
            for sym_b, len_b, w_b, v_b in blocks:
                s = em_ops.em_sufficient_stats(
                    self.params, sym_b, len_b, obs_weights=w_b,
                    gauss_params=self.gauss, gauss_values=v_b,
                )
                stats = s if stats is None else stats + s
            return stats

        pending = None  # (iter_idx, device loglik, dispatch time)

        def drain() -> bool:
            nonlocal converged
            if pending is None:
                return False
            it, dev_ll, dispatch_t0 = pending
            ll = float(dev_ll)
            logliks.append(ll)
            wall = time.time() - dispatch_t0
            logger.info("EM iter %d: loglik %.4f (%.2fs, %.3g pos/s)",
                        it, ll, wall, n_positions / max(wall, 1e-9))
            if metrics is not None:
                metrics.write(
                    iter=it, loglik=ll, wall=wall,
                    positions_per_sec=n_positions / max(wall, 1e-9),
                )
            if len(logliks) >= 2 and \
                    abs(logliks[-1] - logliks[-2]) < convergence_tol:
                converged = True
            return converged

        for it in range(max_iterations):
            it_t0 = time.time()
            stats = estep()
            self.params = em_ops.em_m_step(stats, self.params, sizes, masks,
                                           epsilon)
            if self.gauss is not None:
                self.gauss = gauss_m_step(stats.gauss_n, stats.gauss_x,
                                          stats.gauss_x2, self.gauss,
                                          fix_states=fix)
            if drain():  # the previous iteration's loglik
                break
            pending = (it, stats.loglik, it_t0)
            if checkpoint_path and (it + 1) % checkpoint_every == 0:
                self.save(checkpoint_path, extra={"iteration": it})
        if not converged:
            drain()
        return FitResult(logliks=logliks, iterations=len(logliks),
                         converged=converged,
                         wall_seconds=time.time() - t0)

    # ------------------------------------------------------------------
    def decode_tables(
        self,
        tables: Sequence[TrackTable],
        chunk_len: int = 4096,
        halo: int = 256,
        rows_per_pass: int = 512,
        weight_arrays: Sequence[np.ndarray] | None = None,
    ) -> tuple[list[np.ndarray], StitchReport]:
        """Viterbi state paths for each table (halo-stitched, with the
        exact decoder as fallback); ``weight_arrays``: per-table f32[L]
        segment weights (``--segment --segLen``)."""
        return viterbi_chunked(
            self.params, tables, chunk_len=chunk_len, halo=halo,
            rows_per_pass=rows_per_pass, weight_arrays=weight_arrays,
            gauss_params=self.gauss,
        )

    def decode_to_bed(
        self,
        tables: Sequence[TrackTable],
        chunk_len: int = 4096,
        halo: int = 256,
    ) -> list[tuple]:
        """Viterbi -> merged (chrom, start, end, stateName) intervals."""
        paths, _ = self.decode_tables(tables, chunk_len, halo)
        out: list[tuple] = []
        for tab, path in zip(tables, paths):
            out.extend(path_to_intervals(
                tab.chrom, tab.start, path, self.state_names
            ))
        return out

    def posterior_decode_tables(
        self,
        tables: Sequence[TrackTable],
        chunk_len: int = 1 << 14,
        halo: int = 256,
        rows_per_pass: int | None = None,
        weight_arrays: Sequence[np.ndarray] | None = None,
    ) -> list[np.ndarray]:
        """Max-posterior (per-position argmax gamma) paths for each
        table: halo chunks with the Viterbi stitcher's boundary check and
        targeted widening, falling back to the exact carried-alpha/beta
        decoder (``parallel.stitch.posterior_chunked``; ``rows_per_pass``
        None takes its route's pass).
        ``weight_arrays``: segment weights (``--segment --segLen``)."""
        paths, _report = posterior_chunked(
            self.params, tables, chunk_len=chunk_len, halo=halo,
            rows_per_pass=rows_per_pass, gauss_params=self.gauss,
            weight_arrays=weight_arrays,
        )
        return paths

    def posterior_distributions(
        self,
        tables: Sequence[TrackTable],
        chunk_len: int = 1 << 14,
        weight_arrays: Sequence[np.ndarray] | None = None,
    ) -> list[np.ndarray]:
        """Per-position posterior state distributions f32[L, S] for each
        table, from the exact chunk sweep (bit-identical to a monolithic
        pass; the device holds one chunk at a time).
        ``weight_arrays``: segment weights (``--segment --segLen``)."""
        S = self.params.num_states
        out = [np.zeros((len(tab), S), np.float32) for tab in tables]

        def consume(b, start, gamma):
            out[b][start : start + len(gamma)] = gamma

        posterior_sweep(self.params, tables, chunk_len=chunk_len,
                        consume=consume, gauss_params=self.gauss,
                        weight_arrays=weight_arrays)
        return out

    def score(
        self, tables: Sequence[TrackTable], chunk_len: int = 1 << 14,
        mesh=None, weight_arrays: Sequence[np.ndarray] | None = None,
    ) -> float:
        """Total log-likelihood of the data (reference: basehmm.score).

        Exact for arbitrarily long tables: the forward alpha is carried
        across chunks of ``chunk_len`` (``dp.streaming_loglik``; on the
        card ``ck.forward_loglik``, the piece-operator scan, per chunk),
        so device memory is O(tables x states) beside one chunk of obs
        and its piece operators (with the
        gaussian tracks' term, and times the segment weights
        ``weight_arrays`` when given: the segment eval's printed score).
        ``mesh`` (the JAX package's sequence-parallel forward) raises: it
        comes with the sharding slice."""
        if mesh is not None:
            raise NotImplementedError(
                f"score over a device mesh is not ported yet ({_MESH_ITEM})"
            )
        mats = [t.symbols for t in tables]
        true_lens = np.asarray([len(m) for m in mats], np.int64)
        L = int(true_lens.max()) if len(mats) else 0
        if L == 0:
            return 0.0                 # every table empty: empty product
        T = mats[0].shape[1]
        n_chunks = -(-L // chunk_len)
        device = self.params.device
        vmats = (None if self.gauss is None
                 else [np.asarray(t.values, np.float32) for t in tables])
        wmats = (None if weight_arrays is None
                 else [np.asarray(w, np.float32) for w in weight_arrays])

        def block_of(arrays, lo, shape, dtype):
            block = np.zeros((len(arrays), chunk_len) + shape, dtype)
            for b, m in enumerate(arrays):
                piece = m[lo : lo + chunk_len]
                block[b, : len(piece)] = piece
            return torch.from_numpy(block).to(device)

        def obs_chunks():
            for c in range(n_chunks):
                lo = c * chunk_len
                yield obs_log_likelihoods(
                    self.params.log_em,
                    block_of(mats, lo, (T,), np.int32), self.gauss,
                    None if vmats is None else block_of(
                        vmats, lo, (vmats[0].shape[1],), np.float32),
                    None if wmats is None else block_of(
                        wmats, lo, (), np.float32),
                )

        lens = [np.clip(true_lens - c * chunk_len, 0, chunk_len)
                for c in range(n_chunks)]
        ll = dp.streaming_loglik(
            self.params.log_start, self.params.log_trans, obs_chunks(),
            lens, final_fn=ck.forward_loglik,
        )
        return float(ll.sum())

    # ------------------------------------------------------------------
    # persistence: the JAX package's npz + JSON format
    # ------------------------------------------------------------------
    def save(self, path: str, extra: dict | None = None) -> None:
        meta = {
            "state_names": self.state_names,
            "tracks": self.track_list.to_dicts(),
            "category_maps": {
                name: cm.to_dict()
                for name, cm in self.category_maps.items()
            },
        }
        if extra:
            self.extra.update(extra)
        if self.extra:
            meta["extra"] = self.extra
        arrays = None
        if self.gauss is not None:
            arrays = {"gauss_mu": self.gauss.mu.cpu().numpy(),
                      "gauss_log_var": self.gauss.log_var.cpu().numpy()}
        save_model(path, self.params, meta, extra_arrays=arrays)

    @classmethod
    def load(cls, path: str, device: str | torch.device
             ) -> "MultitrackHmm":
        params, meta, arrays = load_model(path, device)
        track_list = TrackList.from_dicts(meta["tracks"])
        maps = {
            name: CategoryMap.from_dict(d)
            for name, d in meta["category_maps"].items()
        }
        model = cls(params, track_list, maps, meta["state_names"])
        model.extra = meta.get("extra", {})
        if "gauss_mu" in arrays:
            model.gauss = gauss_ops.from_numpy(
                arrays["gauss_mu"], arrays["gauss_log_var"], device)
        return model


def fit_restarts(
    models: Sequence[MultitrackHmm],
    tables: Sequence[TrackTable],
    max_iterations: int = 100,
    convergence_tol: float = 1e-3,
    masks: em_ops.ParamMasks | None = None,
    epsilon: float = EPSILON,
    chunk_len: int = 1 << 14,
    metrics: JsonlMetrics | None = None,
    obs_weight_arrays: Sequence[np.ndarray] | None = None,
) -> tuple[int, list[FitResult]]:
    """EM over R restarts sharing one staged batch (symbols, segment
    weights and gaussian values): each iteration runs R E-steps (on the
    card, R K1 launch pairs per pass block) and R M-steps, one per
    restart, each restart with its own gaussian parameters when the
    models have gaussian tracks.  The same lagged convergence check as
    ``fit``; converged when every restart's |delta loglik| < tol.

    Each model gets its restart's parameters back.  Returns
    (index of the best final loglik, per-restart FitResults)."""
    R = len(models)
    device = models[0].params.device
    mats = [t.symbols for t in tables]
    chunks = plan_chunks([len(m) for m in mats], chunk_len, halo=0)
    batch = batch_chunks(mats, chunks)
    has_gauss = models[0].gauss is not None
    staged = _stage(_train_arrays(tables, chunks, batch, has_gauss,
                                  obs_weight_arrays), device)
    sizes = models[0].alphabet_sizes
    params = [m.params for m in models]
    gauss = [m.gauss for m in models]
    fix = masks.fix_em_states if masks is not None else None
    # pass blocks: R restarts' E-steps per block
    Lr = staged[0].shape[1]
    budget = _pass_positions(params[0], gauss[0], device)
    rows_per_pass = max(1, budget // max(Lr, 1) // R)
    blocks = _make_passes(staged, rows_per_pass) or [staged]

    t0 = time.time()
    hist: list[np.ndarray] = []          # per-iteration f32[R]
    n_positions = int(batch.lengths.sum())
    pending = None

    def drain() -> bool:
        if pending is None:
            return False
        it, dev_ll, it_t0 = pending
        ll = dev_ll.cpu().numpy()
        hist.append(ll)
        wall = time.time() - it_t0
        logger.info(
            "EM[reps=%d] iter %d: best loglik %.4f (%.2fs, %.3g pos/s "
            "aggregate)", R, it, float(ll.max()), wall,
            R * n_positions / max(wall, 1e-9),
        )
        if metrics is not None:
            metrics.write(iter=it, logliks=[float(x) for x in ll],
                          wall=wall)
        if len(hist) >= 2:
            return bool(
                np.all(np.abs(hist[-1] - hist[-2]) < convergence_tol))
        return False

    converged = False
    for it in range(max_iterations):
        it_t0 = time.time()
        stats = [None] * R
        for sym_b, len_b, w_b, v_b in blocks:
            for r in range(R):
                s = em_ops.em_sufficient_stats(
                    params[r], sym_b, len_b, obs_weights=w_b,
                    gauss_params=gauss[r], gauss_values=v_b,
                )
                stats[r] = s if stats[r] is None else stats[r] + s
        params = [em_ops.em_m_step(s, p, sizes, masks, epsilon)
                  for s, p in zip(stats, params)]
        if has_gauss:
            gauss = [gauss_m_step(s.gauss_n, s.gauss_x, s.gauss_x2, g,
                                  fix_states=fix)
                     for s, g in zip(stats, gauss)]
        if drain():
            converged = True
            break
        pending = (it, torch.stack([s.loglik for s in stats]), it_t0)
    if not converged and drain():
        converged = True

    wall = time.time() - t0
    lls = np.stack(hist) if hist else np.zeros((0, R), np.float32)
    best = int(np.argmax(lls[-1])) if len(lls) else 0
    for m, p, g in zip(models, params, gauss):
        m.params = p
        m.gauss = g
    results = [
        FitResult(logliks=[float(x) for x in lls[:, r]],
                  iterations=len(lls), converged=converged,
                  wall_seconds=wall)
        for r in range(R)
    ]
    return best, results


def path_log_score(params: HmmParams, symbols: np.ndarray,
                   path: np.ndarray, gauss: GaussParams | None = None,
                   values: np.ndarray | None = None,
                   obs_weights: np.ndarray | None = None) -> float:
    """Joint log-probability log P(obs, path) of a decoded state path
    (the quantity the reference's ``decode()`` returns).  Host gathers in
    float64, O(L·T): no device pass.

    ``gauss``/``values``: gaussian-track emissions (each position's
    normal log-density under its path state).  ``obs_weights`` (f32[L],
    segment mode ``--segLen``): scales every position's emission
    log-probability (categorical + gaussian) by its weight, as the
    decode kernels' ``obs * w``; transitions are unweighted."""
    log_em = params.log_em.cpu().numpy().astype(np.float64)
    log_trans = params.log_trans.cpu().numpy().astype(np.float64)
    log_start = params.log_start.cpu().numpy().astype(np.float64)
    path = np.asarray(path, np.int64)
    if len(path) == 0:
        return 0.0
    s = float(log_start[path[0]])
    if len(path) > 1:
        s += float(log_trans[path[:-1], path[1:]].sum())
    em_pos = np.zeros(len(path), np.float64)
    for t in range(symbols.shape[1]):
        em_pos += log_em[path, t, symbols[:, t].astype(np.int64)]
    if gauss is not None and values is not None:
        mu = gauss.mu.cpu().numpy().astype(np.float64)[path]      # [L, G]
        lv = gauss.log_var.cpu().numpy().astype(np.float64)[path]
        x = np.asarray(values, np.float64)
        ll = -0.5 * ((x - mu) ** 2 / np.exp(lv) + lv + LOG_2PI)
        em_pos += np.where(np.isfinite(x), ll, 0.0).sum(axis=1)
    if obs_weights is not None:
        em_pos = em_pos * np.asarray(obs_weights, np.float64)
    return s + float(em_pos.sum())


def path_to_intervals(
    chrom: str, origin: int, path: np.ndarray,
    state_names: list[str],
) -> list[tuple]:
    """State path -> merged (chrom, start, end, name) runs (native
    run-length encoder when available)."""
    path = np.ascontiguousarray(path, np.int32)
    if len(path) == 0:
        return []
    runs = native.runs_encode(path)
    if runs is None:
        edges = np.flatnonzero(np.diff(path)) + 1
        bounds = np.concatenate([[0], edges, [len(path)]])
        runs = (
            bounds[:-1], bounds[1:],
            path[bounds[:-1]],
        )
    starts, ends, states = runs
    return [
        (chrom, origin + int(s), origin + int(e), state_names[int(v)])
        for s, e, v in zip(starts, ends, states)
    ]


def label_tables(
    tables: Sequence[TrackTable],
    labeled_intervals: Sequence[Sequence],
    name_to_idx: dict[str, int],
) -> list[np.ndarray]:
    """Paint per-position state indices from labeled BED intervals;
    unlabeled positions get -1."""
    out = []
    for tab in tables:
        states = np.full(len(tab), -1, dtype=np.int32)
        for iv in labeled_intervals:
            chrom, start, end, name = iv[0], iv[1], iv[2], str(iv[3])
            if chrom != tab.chrom:
                continue
            s = max(start, tab.start) - tab.start
            e = min(end, tab.end) - tab.start
            if s < e:
                states[s:e] = name_to_idx[name]
        out.append(states)
    return out


def _labeled_runs(states: np.ndarray) -> list[tuple[int, int]]:
    """Maximal [s, e) runs of labeled (>= 0) positions."""
    labeled = states >= 0
    if not labeled.any():
        return []
    edges = np.flatnonzero(np.diff(labeled.astype(np.int8)))
    bounds = np.concatenate([[0], edges + 1, [len(states)]])
    return [
        (int(s), int(e))
        for s, e in zip(bounds[:-1], bounds[1:])
        if labeled[s]
    ]
