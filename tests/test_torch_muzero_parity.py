"""The port's MuZero search replayed against the C++ reference's dumps.

``refbench/parity/{go9_mz16,go9_mz50,atari_mz16}.jsonl`` record, move by
move, what the reference binary (rlglab/minizero's own ZeroActor + MCTS,
driven by ``refbench/parity_dump.cpp``; the Atari one built with
``-DATARI=1`` against a deterministic stub ALE) searched with the
integer-exact MuZero parity net of ``tests/parity_common.py``: noise and
rotation off, select by count. The port replays the same games with the
torch twin of that net (``tests/test_torch_muzero_search.py``) and is held
to the checks of ``tests/test_reference_parity.py``:

  * Go (``:131-222``, through ``SelfPlayEngine.search_trees``, the board
    regime of tree step B1): feature checksums, opening legal-move counts,
    root visit counts and chosen actions exact; child means within 2e-4,
    root mean 1e-4, raw root value 1e-5, policy target 2e-4; game
    termination exact.
  * Atari (``:224``, through ``make_muzero_search``, the reward regime):
    features come from the port's ``AtariEnv`` on the stub ALE's numpy
    twin; checksums, legal counts, actions and trajectories exact;
    root visit counts exact except on at most one move per game, which may
    differ by one transposed visit (L1 <= 2: the reference computes the PUCT
    u-term in double, the port in float32, and the value rescale's margins
    are small); means and values within 1e-3 (values up to ~100), policy
    targets 2e-4 where the visits match.
"""

import os

import numpy as np
import pytest
import torch

from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.envs import atari, make_env
from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
from minizero_tpu_torch.search import mcts
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine, search_spec_from_config
from minizero_tpu_torch.selfplay.muzero_search import make_muzero_search
from tests.parity_common import ParityFakeALE, feature_checksum, opening_actions
from tests.test_torch_muzero_search import TorchMuZeroParityNet
from tests.test_torch_reference_parity import COMMON_CONF, PARITY_DIR, _load_dump, _parse


@pytest.fixture
def one_thread():
    """Single-game tensors: intra-op threads only add overhead (and contend
    with the other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dump,sims", [("go9_mz16.jsonl", 16), ("go9_mz50.jsonl", 50)])
def test_go9_muzero_dump_replays_through_the_port(dump, sims, one_thread):
    games = _load_dump(os.path.join(PARITY_DIR, dump))
    assert sum(len(g["moves"]) for g in games.values()) == 74
    cfg = default_config("go").load_string(
        COMMON_CONF + f":env_board_size=9:actor_num_simulation={sims}:actor_use_gumbel=false"
        ":nn_type_name=muzero")
    env = make_env(cfg)
    engine = SelfPlayEngine(env, cfg, TorchMuZeroParityNet("go"), use_bf16=False, device="cpu")
    assert engine.is_muzero and not engine.use_tree_kernel_v2
    assert engine.spec.max_nodes == sims + 1
    before = (fused_tree_step.launches, fused_tree_step.launches_rewards)
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
    assert (fused_tree_step.launches, fused_tree_step.launches_rewards) == before  # CPU: no kernel


def test_atari_mz16_dump_replays_through_the_port(one_thread):
    games = _load_dump(os.path.join(PARITY_DIR, "atari_mz16.jsonl"))
    assert sum(len(g["moves"]) for g in games.values()) == 72
    cfg = default_config("atari").load_string(
        COMMON_CONF + ":actor_num_simulation=16:actor_use_gumbel=false:"
        "actor_mcts_reward_discount=0.997:actor_mcts_value_rescale=true:nn_type_name=muzero")
    spec = atari.atari_spec()
    sspec = search_spec_from_config(cfg, spec)
    assert sspec.init_q_average and sspec.value_rescale and sspec.discount == 0.997
    search = make_muzero_search(TorchMuZeroParityNet("atari", atari_mode=True), sspec,
                                lambda a: atari.action_features(a, spec), num_players=1,
                                discrete_value=True)
    env = atari.AtariEnv(seed=1000, ale_factory=lambda s: ParityFakeALE(s))

    max_dev = {"mean": 0.0, "value": 0.0, "policy": 0.0}
    soft_misses = {g: 0 for g in games}
    for g, rec in sorted(games.items()):
        env.reset(1000 + g)
        draws = opening_actions(g, len(rec["opening"]))
        for j, op in enumerate(rec["opening"]):
            legal = np.nonzero(env.legal_mask())[0]
            assert len(legal) == op["n_legal"], f"g{g} opening{j}: legal count"
            pick = int(legal[draws[j] % len(legal)])
            assert pick == op["action"], f"g{g} opening{j}: action"
            env.step(pick)

        for m, mv in enumerate(rec["moves"]):
            where = f"g{g} m{m}"
            assert not env.is_terminal(), f"{where}: terminated early"
            f = env.features()  # [96, 96, 32]
            fsum = feature_checksum(np.transpose(f, (2, 0, 1)) != 0)
            assert fsum == mv["fsum"], f"{where}: fsum {fsum} != {mv['fsum']}"

            with torch.no_grad():
                trees = search.search_trees(torch.from_numpy(np.asarray(f, np.float32))[None],
                                            torch.from_numpy(env.legal_mask())[None],
                                            torch.ones((1,), dtype=torch.int32))
            action = int(mcts.select_action_by_max_count(trees)[0])
            visits = mcts.root_children_visits(trees)[0].numpy()
            cidx = trees.children_index[0, 0].numpy()
            means = trees.mean[0].numpy()

            ref_counts = _parse(mv["counts"], 3)
            mine = {a: int(visits[a]) for a in range(len(visits)) if visits[a] > 0}
            theirs = {a: int(c) for a, (c, _) in ref_counts.items()}
            if mine != theirs:
                l1 = sum(abs(mine.get(a, 0) - theirs.get(a, 0)) for a in set(mine) | set(theirs))
                assert l1 <= 2 and soft_misses[g] == 0, (
                    f"{where}: visit counts differ beyond the sub-ulp allowance\n"
                    f" mine={mine}\n ref ={theirs}")
                soft_misses[g] += 1
            for a, (cnt, ref_mean) in ref_counts.items():
                if mine.get(a) != int(cnt):
                    continue  # the visit-shifted entry of the allowed miss
                d = abs(float(means[cidx[a]]) - ref_mean)
                max_dev["mean"] = max(max_dev["mean"], d)
                assert d < 1e-3, f"{where} a{a}: child mean"
            assert action == mv["action"], f"{where}: action {action} != {mv['action']}"
            if mine == theirs:  # the root mean is visit-weighted
                max_dev["mean"] = max(max_dev["mean"], abs(float(means[0]) - mv["root_mean"]))
                assert abs(float(means[0]) - mv["root_mean"]) < 1e-3, f"{where}: root mean"
            root_value = float(trees.value[0, 0])
            max_dev["value"] = max(max_dev["value"], abs(root_value - mv["root_value"]))
            assert abs(root_value - mv["root_value"]) < 1e-3, f"{where}: root value"

            if mine == theirs:
                ref_pol = _parse(mv["policy"], 2)
                zsum = sum(p for (p,) in ref_pol.values())
                target = mcts.mcts_policy_target(trees)[0].numpy()
                for a, (p,) in ref_pol.items():
                    d = abs(float(target[a]) - p / zsum)
                    max_dev["policy"] = max(max_dev["policy"], d)
                    assert d < 2e-4, f"{where} a{a}: policy target"

            env.step(action)

        end = rec["end"]
        if end["terminal"]:
            assert env.is_terminal()
            assert env.eval_score() == pytest.approx(end["eval_score"], abs=1e-4)
    assert max_dev["mean"] < 1e-3 and max_dev["policy"] < 2e-4
