"""The port's large-N AlphaZero search replayed against the C++ reference.

``refbench/parity/go9_az50.jsonl`` records, move by move, what the reference
binary (rlglab/minizero's own ZeroActor + MCTS + Go env, driven by
``refbench/parity_dump.cpp``) searched with the integer-exact parity net of
``tests/parity_common.py``: 4 games, 120 search moves, n=50 simulations,
noise and rotation off, select by count. The port replays the same games
through ``SelfPlayEngine.search_trees`` (n=50 gives 51 nodes, so the
large-N loop: tree step B2 and row gather B3, their plain versions on the
CPU) with the torch twin of the parity net, and is held to the checks of
``tests/test_reference_parity.py:131-222``:

  * feature checksums, opening legal-move counts, root visit counts and
    chosen actions: exact;
  * child means within 2e-4, root mean within 1e-4, raw root value within
    1e-5, policy target within 2e-4 (the reference's policy string rounds
    to 6 significant digits);
  * game termination and score: exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.search import mcts
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine
from tests.parity_common import feature_checksum, opening_actions
from tests.test_torch_engine import TorchParityNet

PARITY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "refbench", "parity")
COMMON_CONF = (
    "actor_use_random_rotation_features=false:"
    "actor_use_dirichlet_noise=false:"
    "actor_use_gumbel_noise=false:"
    "actor_select_action_by_softmax_count=false:"
    "actor_select_action_by_count=true"
)


def _load_dump(path):
    games = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            g = games.setdefault(rec["game"], {"opening": [], "moves": [], "end": None})
            if rec["type"] == "opening":
                g["opening"].append(rec)
            elif rec["type"] == "move":
                g["moves"].append(rec)
            else:
                g["end"] = rec
    return games


def _parse(s, fields):
    out = {}
    for part in (s.split(",") if s else []):
        vals = part.split(":")
        out[int(vals[0])] = tuple(float(v) for v in vals[1:fields])
    return out


@pytest.fixture
def one_thread():
    """Single-game tensors: intra-op threads only add overhead (and contend
    with the other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_go9_az50_dump_replays_through_the_port(one_thread):
    games = _load_dump(os.path.join(PARITY_DIR, "go9_az50.jsonl"))
    assert len(games) == 4 and sum(len(g["moves"]) for g in games.values()) == 120
    cfg = default_config("go").load_string(
        COMMON_CONF + ":env_board_size=9:actor_num_simulation=50:actor_use_gumbel=false")
    env = make_env(cfg)
    engine = SelfPlayEngine(env, cfg, TorchParityNet(), use_bf16=False, device="cpu")
    assert engine.use_tree_kernel_v2 and engine.spec.max_nodes == 51
    max_dev = {"root_mean": 0.0, "root_value": 0.0, "policy": 0.0, "child_mean": 0.0}

    for g, rec in sorted(games.items()):
        # opening: the twin of parity_dump.cpp's LCG openings
        state = env.init_random(1, torch.Generator().manual_seed(g), device="cpu")
        draws = opening_actions(g, len(rec["opening"]))
        for j, op in enumerate(rec["opening"]):
            legal = np.nonzero(env.legal_mask(state)[0].numpy())[0]
            assert len(legal) == op["n_legal"], f"g{g} opening{j}: legal count"
            pick = int(legal[draws[j] % len(legal)])
            assert pick == op["action"], f"g{g} opening{j}: action"
            state = env.step(state, torch.tensor([pick], dtype=torch.int32))

        for m, mv in enumerate(rec["moves"]):
            where = f"g{g} m{m}"
            assert not bool(env.is_terminal(state)[0]), f"{where}: terminated early"
            feats = env.features(state)[0].numpy()  # [H, W, C]
            fsum = feature_checksum(np.transpose(feats, (2, 0, 1)) != 0)
            assert fsum == mv["fsum"], f"{where}: feature checksum {fsum} != {mv['fsum']}"

            trees = engine.search_trees(state)
            action = int(mcts.select_action_by_max_count(trees)[0])
            target = mcts.mcts_policy_target(trees)[0].numpy()
            visits = mcts.root_children_visits(trees)[0].numpy()
            cidx = trees.children_index[0, 0].numpy()
            means = trees.mean[0].numpy()
            root_mean = float(trees.mean[0, 0])
            root_value = float(trees.value[0, 0])

            ref_counts = _parse(mv["counts"], 3)
            mine = {a: int(visits[a]) for a in range(len(visits)) if visits[a] > 0}
            theirs = {a: int(c) for a, (c, _) in ref_counts.items()}
            assert mine == theirs, f"{where}: visit counts differ\n mine={mine}\n ref ={theirs}"
            for a, (_, ref_mean) in ref_counts.items():
                d = abs(float(means[cidx[a]]) - ref_mean)
                max_dev["child_mean"] = max(max_dev["child_mean"], d)
                assert d < 2e-4, f"{where} a{a}: child mean"
            assert action == mv["action"], f"{where}: action {action} != {mv['action']}"
            max_dev["root_mean"] = max(max_dev["root_mean"], abs(root_mean - mv["root_mean"]))
            max_dev["root_value"] = max(max_dev["root_value"], abs(root_value - mv["root_value"]))
            assert abs(root_mean - mv["root_mean"]) < 1e-4, f"{where}: root mean"
            assert abs(root_value - mv["root_value"]) < 1e-5, f"{where}: root value"

            ref_pol = _parse(mv["policy"], 2)
            zsum = sum(p for (p,) in ref_pol.values())
            for a, (p,) in ref_pol.items():
                d = abs(float(target[a]) - p / zsum)
                max_dev["policy"] = max(max_dev["policy"], d)
                assert d < 2e-4, f"{where} a{a}: policy target {target[a]} vs {p / zsum}"

            state = env.step(state, torch.tensor([action], dtype=torch.int32))

        end = rec["end"]
        term = bool(env.is_terminal(state)[0])
        assert term == end["terminal"], f"g{g}: terminal mismatch"
        if term:
            assert float(env.eval_score(state)[0]) == pytest.approx(end["eval_score"], abs=1e-6)

    assert max_dev["root_mean"] < 1e-4 and max_dev["policy"] < 2e-4
