"""Timing helpers for the benchmark tools.

Counterpart of ``tehmm_tpu/utils/profiling.py``; only ``marginal_time``
is here so far (``trace`` and ``StageTimer`` come with the packaging
slice).
"""

from __future__ import annotations

import time


def marginal_time(run, sync, iters: int, robust: bool = False) -> float:
    """Two-point marginal-rate timing: seconds per iteration of ``run``.

    A PyTorch call on a CUDA tensor returns once its kernels are queued,
    and a timed chain of calls pays fixed costs that do not grow with its
    length: filling the launch queue, the last ``torch.cuda.synchronize()``
    and the fetch of a scalar.  Timing two chain lengths and taking
    ``(T2 - T1) / (n2 - n1)`` leaves the sustained time of one iteration,
    which is the device time when the card is the bottleneck and the
    host's launch time when a Python loop of small kernels is.  Every
    benchmark tool of the port times through this one function.

    Args:
      run: zero-argument callable that launches one iteration (it may
        return before the card is done).
      sync: called with ``run()``'s result; must wait for the card to
        drain (``torch.cuda.synchronize()`` for card work, then e.g. a
        scalar fetch) and returns nothing that is used.
      iters: length n1 of the short chain (the long chain is 6 x n1).
      robust: take the least of two chains per point, and fall back to
        the long chain's average when the difference is not positive;
        for noisy CPU hosts.
    """
    sync(run())                       # build kernels, warm caches

    def chain(n):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = run()
        sync(out)
        return time.perf_counter() - t0

    if robust:
        chain(iters)
        t1 = min(chain(iters), chain(iters))
        t2 = min(chain(6 * iters), chain(6 * iters))
    else:
        t1 = chain(iters)
        t2 = chain(6 * iters)
    dt = (t2 - t1) / (5 * iters)
    return dt if dt > 0 else t2 / (6 * iters)
