"""HMM parameters as three torch tensors.

Counterpart of ``tehmm_tpu/models/params.py``; the conventions are the
same:

* All probabilities are stored in natural-log space, float32.
* "log zero" is the finite ``LOG_ZERO`` (``tehmm_tpu_torch.utils.common``) —
  never IEEE -inf.
* ``log_em`` is padded to the largest alphabet across tracks; entries for
  symbols ``v >= alphabet_size[t]`` are stored as 0.0 and never selected.
* Symbol 0 of every track is *missing data* and emits log-prob 0.0 in
  every state.

Model files are the JAX package's format (npz arrays plus a JSON meta
blob), so a model written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np
import torch

# Reserved per-track symbol index for missing/unannotated positions.
MISSING_SYMBOL = 0


@dataclasses.dataclass(frozen=True)
class HmmParams:
    """Log-space HMM tables on one device.

    Attributes:
      log_start: f32[S] log initial state probabilities.
      log_trans: f32[S, S] log transition probabilities, row i -> col j.
      log_em:    f32[S, T, V] per-state per-track categorical log emission
                 probabilities, padded to V = max alphabet size.
    """

    log_start: torch.Tensor
    log_trans: torch.Tensor
    log_em: torch.Tensor

    @property
    def num_states(self) -> int:
        return self.log_start.shape[0]

    @property
    def num_tracks(self) -> int:
        return self.log_em.shape[1]

    @property
    def max_symbols(self) -> int:
        return self.log_em.shape[2]

    @property
    def device(self) -> torch.device:
        return self.log_start.device


def from_numpy(log_start, log_trans, log_em,
               device: str | torch.device) -> HmmParams:
    """Array-likes (NumPy, or the JAX package's arrays via np.asarray) ->
    float32 contiguous tensors on ``device``."""
    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return HmmParams(t(log_start), t(log_trans), t(log_em))


def _symbol_mask(num_tracks: int, max_symbols: int,
                 alphabet_sizes: Sequence[int]) -> np.ndarray:
    """bool[T, V]: True where symbol v is a *real, non-missing* symbol."""
    mask = np.zeros((num_tracks, max_symbols), dtype=bool)
    for t, size in enumerate(alphabet_sizes):
        mask[t, 1:size] = True  # symbol 0 = missing, excluded
    return mask


def apply_emission_conventions(
    log_em: np.ndarray, alphabet_sizes: Sequence[int]
) -> np.ndarray:
    """Force the missing-symbol and padding conventions onto a log_em table."""
    S, T, V = log_em.shape
    out = np.array(log_em, dtype=np.float32, copy=True)
    mask = _symbol_mask(T, V, alphabet_sizes)
    out[:, :, MISSING_SYMBOL] = 0.0
    out[:, ~mask & (np.arange(V)[None, :] != MISSING_SYMBOL)] = 0.0
    return out


def _flat_tables(num_states: int, alphabet_sizes: Sequence[int]):
    S = num_states
    T = len(alphabet_sizes)
    V = max(int(v) for v in alphabet_sizes)
    log_start = np.full((S,), -np.log(S), dtype=np.float32)
    log_trans = np.full((S, S), -np.log(S), dtype=np.float32)
    log_em = np.zeros((S, T, V), dtype=np.float32)
    for t, size in enumerate(alphabet_sizes):
        n_real = max(int(size) - 1, 1)  # exclude missing symbol
        log_em[:, t, 1:size] = -np.log(n_real)
    return log_start, log_trans, apply_emission_conventions(
        log_em, alphabet_sizes
    )


def init_flat(num_states: int, alphabet_sizes: Sequence[int],
              device: str | torch.device) -> HmmParams:
    """Uniform (flat) initialization."""
    return from_numpy(*_flat_tables(num_states, alphabet_sizes), device)


def init_random(
    num_states: int,
    alphabet_sizes: Sequence[int],
    seed: int,
    device: str | torch.device,
    rand_range: tuple[float, float] = (0.1, 0.9),
) -> HmmParams:
    """Random emissions, flat start/transitions.  Draws from
    ``numpy.random.RandomState(seed)`` in the reference's order, so a
    seed gives the same tables as ``tehmm_tpu.models.params.init_random``."""
    rng = np.random.RandomState(seed)
    log_start, log_trans, _ = _flat_tables(num_states, alphabet_sizes)
    S = num_states
    T = len(alphabet_sizes)
    V = max(int(v) for v in alphabet_sizes)
    log_em = np.zeros((S, T, V), dtype=np.float32)
    lo, hi = rand_range
    for t, size in enumerate(alphabet_sizes):
        n_real = int(size) - 1
        if n_real <= 0:
            continue
        w = rng.uniform(lo, hi, size=(S, n_real))
        w = w / w.sum(axis=1, keepdims=True)
        log_em[:, t, 1:size] = np.log(w)
    log_em = apply_emission_conventions(log_em, alphabet_sizes)
    return from_numpy(log_start, log_trans, log_em, device)


def save_model(
    path: str, params: HmmParams, meta: dict,
    extra_arrays: dict | None = None,
) -> None:
    """npz of the three tables + a JSON ``meta`` blob (and any
    ``extra_arrays``) — byte-compatible with the JAX package's files."""
    np.savez(
        path if path.endswith(".npz") else path + ".npz",
        log_start=params.log_start.cpu().numpy(),
        log_trans=params.log_trans.cpu().numpy(),
        log_em=params.log_em.cpu().numpy(),
        meta=np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8
        ),
        **{k: np.asarray(v) for k, v in (extra_arrays or {}).items()},
    )


def load_model(path: str, device: str | torch.device
               ) -> tuple[HmmParams, dict, dict]:
    """Returns (params on ``device``, meta, extra_arrays)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    core = {"log_start", "log_trans", "log_em", "meta"}
    with np.load(path) as z:
        params = from_numpy(
            z["log_start"], z["log_trans"], z["log_em"], device
        )
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        extra = {k: z[k] for k in z.files if k not in core}
    return params, meta, extra
