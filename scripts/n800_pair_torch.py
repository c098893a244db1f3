"""One round of the README's strength protocol through the PyTorch port.

The reference publishes strength at n=800, the most visited action, noise
off (its README.md:203); ``scripts/n800_pair.py`` plays that protocol with
the JAX package between two checkpoints of a run, 4 uniform opening plies
a game pair and at most 96 games in lock-step. This script plays the same
match on the port (``minizero_tpu_torch.eval.match.play_match``): the
trained Go 9x9 AlphaZero net of ``minizero_tpu_torch/assets/`` (the
``runs/go9_az200_r3b`` run's iteration 25000) against a net made from
``init_seed``. That init is the port's own, not the run's iteration-0
checkpoint. Prints one JSON line: W-L-D of the trained net, seconds, the
plies searched (from the tree-step launch counts on the card), ms per ply,
and the card's name and power limit.

    python3 scripts/n800_pair_torch.py [games=96] [sims=800] [opening_plies=4] \
        [init_seed=0] [cpu]

On the card it runs the large-N loop (tree step B2 with capacity grown
65 -> ... -> 801, the row gather B3); ``cpu`` runs the plain versions on
the CPU (slow at full width: use few games and simulations there).
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# scripts/elo_curve.py:16's override of the training config
PROTOCOL = ("actor_num_simulation={sims}:actor_select_action_by_count=true:"
            "actor_select_action_by_softmax_count=false:actor_use_dirichlet_noise=false:"
            "actor_use_gumbel_noise=false")
TRAINED = os.path.join(ROOT, "minizero_tpu_torch", "assets", "go9_az200_r3b_iter25000.npz")
TRAINED_ITERATION = 25000


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(games=96, sims=800, opening_plies=4, init_seed=0, platform="gpu"):
    import torch

    from minizero_tpu_torch.config import algorithm_preset, default_config
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.eval.match import elo_from_win_rate, play_match
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.ops.gather_rows import gather_rows
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2
    from minizero_tpu_torch.weights import from_jax_variables, load_variables_npz

    games, sims, opening_plies = int(games), int(sims), int(opening_plies)
    device = "cpu" if platform == "cpu" else "cuda"
    cfg = default_config("go", **algorithm_preset("az")).load_string(PROTOCOL.format(sims=sims))
    cfg = cfg.replace(zero_num_parallel_games=min(games, 96))
    spec = make_env(cfg).spec
    trained = create_network(cfg, spec)
    trained.load_state_dict(from_jax_variables(load_variables_npz(TRAINED), hidden_hw=81))
    seeded = init_network(create_network(cfg, spec), seed=int(init_seed))
    before = (fused_tree_step.launches, fused_tree_step_v2.launches, gather_rows.launches)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = play_match(cfg, trained, seeded, num_games=games, seed=77000 + TRAINED_ITERATION,
                   opening_random_plies=opening_plies, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    b1, b2, b3 = (after - b for after, b in zip(
        (fused_tree_step.launches, fused_tree_step_v2.launches, gather_rows.launches), before))
    plies = (b1 + b2) // (sims + 1) if device == "cuda" else None
    print(json.dumps({
        "pair": f"trained {TRAINED_ITERATION} vs seeded init {init_seed}",
        "protocol": {"num_simulation": sims, "eval_mode": True, "select_by_count": True,
                     "noise": False, "opening_random_plies": opening_plies,
                     "parallel_games": cfg.zero_num_parallel_games},
        "wins": r.p1_wins, "losses": r.p2_wins, "draws": r.draws,
        "win_rate": r.p1_win_rate, "elo": elo_from_win_rate(r.p1_win_rate),
        "seconds": seconds, "plies": plies,
        "ms_per_ply": 1e3 * seconds / plies if plies else None,
        "launches": {"tree_step": b1, "tree_step_v2": b2, "gather_rows": b3},
        "device": card() if device == "cuda" else "cpu",
    }), flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "cpu"]
    main(*args, platform="cpu" if "cpu" in sys.argv[1:] else "gpu")
