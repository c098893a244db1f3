"""TTY progress bar for long host-side loops (a copy of
``minizero_tpu/utils/progress.py``, which imports no JAX).

Counterpart of the reference's header-only tqdm (``minizero/utils/tqdm.h``,
format "{desc}{percentage}|{bar}|{index}/{total} [{elapsed}<{remaining}]",
used by its seki-table generation). Renders only on a TTY — log files and
piped output stay clean — and costs nothing when disabled.
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from typing import Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")


def _fmt_secs(s: float) -> str:
    s = int(max(0.0, s))
    if s >= 3600:
        return f"{s // 3600}:{s % 3600 // 60:02d}:{s % 60:02d}"
    return f"{s // 60:02d}:{s % 60:02d}"


class ProgressBar:
    """Minimal tqdm-style bar: ``with ProgressBar(n, "desc") as p: p.step()``."""

    def __init__(self, total: int, desc: str = "", stream=None,
                 min_interval_s: float = 0.1):
        self.total = max(int(total), 1)
        self.desc = desc
        self.stream = sys.stderr if stream is None else stream
        self.enabled = (
            hasattr(self.stream, "isatty") and self.stream.isatty()
            and os.environ.get("MINIZERO_NO_PROGRESS") is None
        )
        self.n = 0
        self._t0 = time.time()
        self._last_draw = 0.0
        self._min_interval = min_interval_s

    def step(self, k: int = 1) -> None:
        self.n += k
        now = time.time()
        if self.enabled and (
                now - self._last_draw >= self._min_interval or self.n >= self.total):
            self._last_draw = now
            self._draw(now)

    def _draw(self, now: float) -> None:
        frac = min(self.n / self.total, 1.0)
        elapsed = now - self._t0
        remaining = elapsed / frac - elapsed if frac > 0 else 0.0
        cols = shutil.get_terminal_size((80, 24)).columns
        head = f"{self.desc}{frac * 100:3.0f}%|"
        tail = (f"| {self.n}/{self.total} "
                f"[{_fmt_secs(elapsed)}<{_fmt_secs(remaining)}]")
        width = max(cols - len(head) - len(tail) - 1, 4)
        filled = int(width * frac)
        bar = "█" * filled + " " * (width - filled)
        self.stream.write(f"\r{head}{bar}{tail}")
        self.stream.flush()

    def close(self) -> None:
        if self.enabled and self.n:
            self._draw(time.time())
            self.stream.write("\n")
            self.stream.flush()

    def __enter__(self) -> "ProgressBar":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def progress(items: Iterable[T], desc: str = "",
             total: Optional[int] = None) -> Iterator[T]:
    """Iterate ``items`` with a progress bar (like ``tqdm(iterable)``)."""
    if total is None:
        try:
            total = len(items)  # type: ignore[arg-type]
        except TypeError:
            total = 0
    bar = ProgressBar(total or 1, desc)
    try:
        for x in items:
            yield x
            bar.step()
    finally:
        bar.close()
