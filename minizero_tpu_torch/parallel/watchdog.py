"""Collective watchdog: fail fast instead of hanging when a peer dies (a
copy of ``minizero_tpu/parallel/watchdog.py``; pure Python).

The reference's TCP server simply drops lost workers
(``zero_server.cpp:86,148``, ``base_server.h:150-158``). In a data-parallel
job there are no droppable workers: every rank takes part in every
collective, so a dead or wedged peer blocks an all-reduce or a barrier for
as long as the process group's own timeout (30 minutes by default). The
recovery contract is therefore: detect the stall, abort the whole process
promptly, and restart from the last checkpoint (which ``ZeroLoop.resume``
rebuilds, including the replay window).

``collective_watchdog`` arms a daemon timer around a collective; if the
collective does not finish in time the process prints a diagnostic and
hard-exits with :data:`WATCHDOG_EXIT_CODE` (a blocked collective cannot
be interrupted by an exception — ``os._exit`` is the only escape). It
covers the case of a peer that stays alive but stops participating
(a wedged host, a hung device, a livelocked loop).
"""

from __future__ import annotations

import os
import sys
import threading
from contextlib import contextmanager

WATCHDOG_EXIT_CODE = 42


@contextmanager
def collective_watchdog(name: str, timeout_s: float, logger=None):
    """Abort the process if the wrapped block runs longer than ``timeout_s``
    seconds. ``timeout_s <= 0`` disables the watchdog."""
    if timeout_s <= 0:
        yield
        return
    done = threading.Event()

    def watch():
        if not done.wait(timeout_s):
            msg = (
                f"[Watchdog] collective '{name}' still blocked after "
                f"{timeout_s:.0f}s — peer host lost or wedged; aborting for "
                f"restart-from-checkpoint (exit {WATCHDOG_EXIT_CODE})"
            )
            if logger is not None:
                try:
                    logger(msg)
                except Exception:
                    pass
            print(msg, file=sys.stderr, flush=True)
            os._exit(WATCHDOG_EXIT_CODE)

    t = threading.Thread(target=watch, name=f"watchdog-{name}", daemon=True)
    t.start()
    try:
        yield
    finally:
        done.set()
