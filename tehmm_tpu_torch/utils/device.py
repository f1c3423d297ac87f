"""Explicit device resolution.

Counterpart of ``tehmm_tpu/utils/platform.py``.  The port keeps no
global device default and has no compile cache to set up: every entry
point takes a device name and resolves it here, and asking for CUDA on a
host without it raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> a ``torch.device``.

    Raises RuntimeError when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is False, and ValueError for any other
    device type."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} was asked for but "
                "torch.cuda.is_available() is False (pass --device cpu "
                "to run the plain-torch path)"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} was asked for but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (use cuda or cpu)")
    return dev
