"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Sources live in ``minizero_tpu_torch/csrc/``; each ``<name>.cu`` becomes
``minizero_tpu_torch/_build/<name>-<hash>.so``, keyed by a hash of the source
and the flags, at first use. ``nvcc`` is looked up in ``$CUDA_HOME/bin``,
then ``/usr/local/cuda/bin``, then ``PATH``. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# Hopper (sm_90a). No FMA contraction: the kernels are held against their
# plain PyTorch versions, whose separate multiply and add round twice, and a
# flipped tie changes a whole tree walk. logf/sqrtf/division stay IEEE (no
# fast math). -Xptxas -v reports registers and shared memory per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class BuildResult:
    name: str
    path: str
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas register / shared memory report)


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
        "the CUDA kernels of minizero_tpu_torch need the CUDA toolkit")


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build(names: Sequence[str]) -> List[BuildResult]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together. Raises ``RuntimeError`` with the compiler's
    output when one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = []
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = BuildResult(name, out, seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return [results[n] for n in names]


# what a launcher returns, instead of a cudaError, for a shape whose block
# needs more shared memory than the card lets a block hold
SHAPE_TOO_LARGE = -1

_LOADED: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed)."""
    if name not in _LOADED:
        (res,) = build([name])
        _LOADED[name] = ctypes.CDLL(res.path)
    return _LOADED[name]


def kernel_attributes(name: str, *shape: int) -> Dict[str, int]:
    """Registers per thread and static and dynamic shared memory per block of
    the kernel of ``<name>.cu`` that a launch at ``shape`` runs, from the
    source's ``<name>_attributes`` function (``cudaFuncGetAttributes``;
    needs the card)."""
    fn = getattr(load(name), f"{name}_attributes")
    vals = [ctypes.c_int() for _ in range(3)]
    rc = fn(*[ctypes.c_int(x) for x in shape], *[ctypes.byref(v) for v in vals])
    if rc == SHAPE_TOO_LARGE:
        raise ValueError(f"{name}: a block at {shape} needs more shared memory than the card holds")
    if rc != 0:
        raise RuntimeError(f"{name}_attributes failed (cudaError {rc})")
    return dict(zip(("registers", "static_smem", "dynamic_smem"), (v.value for v in vals)))
