"""TicTacToe replayed against the C++ reference: the ``ttt_az16``,
``ttt_gaz16``, ``ttt_mz16`` and ``ttt_gmz16`` dumps of ``refbench/parity/``
(AlphaZero and MuZero, each with and without Gumbel, n=16) through the
port's v1 loop and MuZero search, held to the checks of
``tests/test_reference_parity.py`` (``tests/torch_reference_replay.py``)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_reference_replay import replay_dump  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

from tests.test_torch_engine import TorchParityNet  # noqa: E402
from tests.test_torch_muzero_search import TorchMuZeroParityNet  # noqa: E402


@pytest.mark.parametrize("dump,conf,kind,moves", [
    ("ttt_az16.jsonl", "actor_num_simulation=16:actor_use_gumbel=false", "alphazero", 38),
    ("ttt_gaz16.jsonl", "actor_num_simulation=16:actor_use_gumbel=true:actor_gumbel_sample_size=4",
     "alphazero", 21),
    ("ttt_mz16.jsonl", "actor_num_simulation=16:actor_use_gumbel=false:nn_type_name=muzero",
     "muzero", 33),
    ("ttt_gmz16.jsonl", "actor_num_simulation=16:actor_use_gumbel=true:actor_gumbel_sample_size=4:"
     "nn_type_name=muzero", "muzero", 30),
], ids=["ttt_az16", "ttt_gaz16", "ttt_mz16", "ttt_gmz16"])
def test_ttt_dump_replays_through_the_port(dump, conf, kind, moves):
    net = TorchParityNet("tictactoe") if kind == "alphazero" else TorchMuZeroParityNet("tictactoe")
    replay_dump(dump, "tictactoe", conf, net, moves)
