"""The flagship's own search (Go 9x9, Gumbel AlphaZero, n=16) replayed
against the C++ reference: ``refbench/parity/go9_gaz16.jsonl`` through the
port's v1 loop (tree step B1's plain version on the CPU), held to the
checks of ``tests/test_reference_parity.py`` (``tests/torch_reference_replay.py``)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_reference_replay import replay_dump  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

from tests.test_torch_engine import TorchParityNet  # noqa: E402


def test_go9_gaz16_dump_replays_through_the_port():
    replay_dump("go9_gaz16.jsonl", "go",
                "env_board_size=9:actor_num_simulation=16:actor_use_gumbel=true:"
                "actor_gumbel_sample_size=16", TorchParityNet(), 160)
