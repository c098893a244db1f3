"""minizero_tpu_torch — the PyTorch/CUDA port of ``minizero_tpu``.

The JAX package ``minizero_tpu`` is the reference this port is held against;
this package imports neither it nor JAX. Each module keeps the name of its
JAX counterpart. Entry points run on the CUDA card unless the caller asks
for ``device="cpu"`` (as the CPU tests do); where a card is needed and none
is present they raise instead of falling back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; ``cpu`` only when asked for by name.

    Raises ``RuntimeError`` when a CUDA device is wanted and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "minizero_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``. To the card it goes through
    pinned memory without blocking the host; the pinned buffer lives until
    the copy is done (torch's host allocator waits for the copy's stream)."""
    t = torch.from_numpy(np.require(x, requirements="CW"))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
