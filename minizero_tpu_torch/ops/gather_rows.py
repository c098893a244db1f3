"""Per-game row gather ``out[b] = x[b, idx[b]]`` (port of
``minizero_tpu/ops/gather_rows.py``).

The large-N AlphaZero loop fetches the selected parent's packed env state
(``ops/state_blob.py``) with it once per simulation. ``gather_rows``
launches the hand-written CUDA kernel ``csrc/gather_rows.cu`` on CUDA
tensors and calls ``gather_rows_reference``, its plain PyTorch version, on
CPU tensors. Any ``B``, ``N`` and ``W`` are taken. The kernel copies rows
in 16-byte elements where ``W`` is a multiple of 4 words and both bases are
16-byte aligned (the aligned path, which the engine's padded blob takes),
else in 4-byte words (the generic path); the kernel's C launcher decides
and reports which path it took.

A game whose index lies outside ``[0, N)`` (the engine passes -1 for "skip")
gets no row: the kernel leaves that output row undefined and the plain
version returns zeros there, so the two agree on every row that is defined.
"""

from __future__ import annotations

import ctypes

import torch


def gather_rows_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x`` [B, N, W], ``idx`` [B] -> [B, W]; rows whose
    index lies outside ``[0, N)`` are zeros."""
    b, n = x.shape[0], x.shape[1]
    idx = idx.long()
    valid = (idx >= 0) & (idx < n)
    rows = x[torch.arange(b, device=x.device), idx.clamp(0, max(n - 1, 0))]
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=x.dtype, device=x.device))


def _library():
    from minizero_tpu_torch.ops import _build

    fn = _build.load("gather_rows").gather_rows_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return fn


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` int32[B, N, W], ``idx`` int32[B] -> int32[B, W].

    CUDA tensors: the CUDA kernel (``gather_rows.launches`` counts its
    launches, ``gather_rows.launches_aligned`` those on the aligned path);
    CPU tensors: ``gather_rows_reference``."""
    if x.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_reference(x, idx)
    if x.device.type != "cuda" or idx.device != x.device:
        raise ValueError(f"gather_rows: x on {x.device}, idx on {idx.device}; "
                         "both must lie on one CUDA device or on the CPU")
    if x.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"gather_rows: x {x.dtype} and idx {idx.dtype} must be int32")
    if x.dim() != 3 or idx.shape != (x.shape[0],):
        raise ValueError(f"gather_rows: x {tuple(x.shape)} must be [B, N, W] and idx "
                         f"{tuple(idx.shape)} must be [B]")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows: x and idx must be contiguous")
    b, n, w = x.shape
    out = torch.empty((b, w), dtype=torch.int32, device=x.device)
    aligned = ctypes.c_int()
    rc = _library()(b, n, w, x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                    torch.cuda.current_stream(x.device).cuda_stream, ctypes.byref(aligned))
    if rc != 0:
        raise RuntimeError(f"gather_rows: CUDA kernel launch failed (cudaError {rc})")
    gather_rows.launches += 1
    gather_rows.launches_aligned += aligned.value
    return out


gather_rows.launches = 0
gather_rows.launches_aligned = 0
