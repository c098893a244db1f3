"""The replay of a C++ reference dump through the port, shared by
``tests/test_torch_reference_parity_*.py``.

A dump in ``refbench/parity/`` records, move by move, what the reference
binary (rlglab/minizero's own ZeroActor + MCTS + env, driven by
``refbench/parity_dump.cpp``) searched with the integer-exact parity nets of
``tests/parity_common.py``: noise and rotation off, select by count. The
port replays the same games through ``SelfPlayEngine.search_trees`` with the
torch twin of the net and is held to the checks of
``tests/test_reference_parity.py:131-222``:

  * feature checksums, opening legal-move counts, root visit counts and
    chosen actions (the Gumbel decision for Gumbel configs): exact;
  * child means within 2e-4, root mean within 1e-4, raw root value within
    1e-5; the policy target (the completed-Q target for Gumbel configs)
    within 2e-4, 2e-3 with Gumbel (the reference's policy string rounds to
    6 significant digits; docs/Parity.md);
  * game termination and score: exact.

Not a test module: import ``replay_dump``."""

import os

import numpy as np
import pytest
import torch

from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
from minizero_tpu_torch.search import gumbel as gz
from minizero_tpu_torch.search import mcts
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine
from tests.parity_common import feature_checksum, opening_actions
from tests.test_torch_reference_parity import COMMON_CONF, PARITY_DIR, _load_dump, _parse


def replay_dump(dump, game, conf, net, num_moves):
    """Replay ``refbench/parity/<dump>`` (``num_moves`` search moves in
    all) through the port on the CPU; returns the largest deviations."""
    games = _load_dump(os.path.join(PARITY_DIR, dump))
    assert sum(len(g["moves"]) for g in games.values()) == num_moves
    cfg = default_config(game).load_string(COMMON_CONF + ":" + conf)
    env = make_env(cfg)
    engine = SelfPlayEngine(env, cfg, net, use_bf16=False, device="cpu")
    spec = engine.spec
    assert not engine.use_tree_kernel_v2  # n=16: the v1 loop, tree step B1
    before = (fused_tree_step.launches, fused_tree_step.launches_rewards)
    max_dev = {"root_mean": 0.0, "root_value": 0.0, "policy": 0.0, "child_mean": 0.0}
    tol = 2e-3 if spec.use_gumbel else 2e-4

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
            if spec.use_gumbel:
                action = int(gz.decide_action(spec, trees)[0])
                target = gz.improved_policy_target(spec, trees)[0].numpy()
            else:
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
                assert d < tol, f"{where} a{a}: policy target {target[a]} vs {p / zsum}"

            state = env.step(state, torch.tensor([action], dtype=torch.int32))

        end = rec["end"]
        term = bool(env.is_terminal(state)[0])
        assert term == end["terminal"], f"g{g}: terminal mismatch"
        if term:
            assert float(env.eval_score(state)[0]) == pytest.approx(end["eval_score"], abs=1e-6)

    assert max_dev["root_mean"] < 1e-4 and max_dev["policy"] < tol
    assert (fused_tree_step.launches, fused_tree_step.launches_rewards) == before  # CPU: no kernel
    return max_dev
