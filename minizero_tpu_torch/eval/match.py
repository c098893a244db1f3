"""Evaluation matches and Elo (port of ``minizero_tpu/eval/match.py``).

The reference plays head-to-head games through gogui-twogtp, two GTP
processes a game (``tools/self-eval.sh``, ``tools/fight-eval.sh``); here a
whole batch of games runs in lock-step on the card, each network in its
own eval engine (no exploration noise, the most visited action), and each
game takes the move of the engine whose network owns the player to move.
Colours balance across the match as the reference's alternate per game
pair (``self-eval.sh:86-118``). Elo from a win rate follows
``tools/eval.py:64-71``: ``400 * log10(w / (1 - w))``.
"""

from __future__ import annotations

import csv
import math
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from minizero_tpu_torch.config import Config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.envs.base import select_states
from minizero_tpu_torch.models.factory import create_network
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine
from minizero_tpu_torch.utils.progress import ProgressBar


@dataclass
class MatchResult:
    p1_wins: int
    p2_wins: int
    draws: int

    @property
    def games(self) -> int:
        return self.p1_wins + self.p2_wins + self.draws

    @property
    def p1_win_rate(self) -> float:
        # draws count half, like twogtp scoring
        return (self.p1_wins + 0.5 * self.draws) / max(self.games, 1)


def elo_from_win_rate(win_rate: float) -> float:
    """reference tools/eval.py compute_elo: 400*log10(w/(1-w)) capped to
    +/-1000 per match (sweeps count +/-1000)."""
    if win_rate >= 1.0:
        return 1000.0
    if win_rate <= 0.0:
        return -1000.0
    return max(min(400.0 * math.log10(win_rate / (1.0 - win_rate)), 1000.0), -1000.0)


def load_checkpoint_variables(path: str, cfg: Config) -> nn.Module:
    """A fresh network holding the weights of a ``ZeroLoop`` checkpoint of
    the port (``zero/loop.py``: a ``torch.save`` whose ``"model"`` is the
    state dict), on the CPU; an engine moves it to its device."""
    net = create_network(cfg, make_env(cfg).spec)
    net.load_state_dict(torch.load(path, map_location="cpu", weights_only=True)["model"])
    return net.eval()


def _checkpoints(run_dir: str) -> List[str]:
    """The run's checkpoint file names, oldest training step first."""
    model_dir = os.path.join(run_dir, "model")
    return sorted((f for f in os.listdir(model_dir) if f.endswith(".ckpt")),
                  key=lambda f: int(f.split("_")[-1].split(".")[0]))


# envs whose turn strictly alternates every action (pass/swap are explicit
# actions) — the precondition for the synchronized match path
_ALTERNATING = ("go", "killallgo", "nogo", "tictactoe", "othello", "gomoku",
                "hex", "havannah", "breakthrough", "clobber")
# plies between two reads of the batch's finished flags on the host
PLIES_PER_CHECK = 16


def _score(a_wins: int, b_wins: int, draws: int, score: float, a_is_p1: bool):
    """The running (A wins, B wins, draws) after one game of outcome
    ``score`` (Player 1's view)."""
    if score > 0:
        return (a_wins + 1, b_wins, draws) if a_is_p1 else (a_wins, b_wins + 1, draws)
    if score < 0:
        return (a_wins, b_wins + 1, draws) if a_is_p1 else (a_wins + 1, b_wins, draws)
    return a_wins, b_wins, draws + 1


def play_match(
    cfg: Config,
    network_a: nn.Module,
    network_b: nn.Module,
    num_games: int = 100,
    seed: int = 0,
    max_moves: Optional[int] = None,
    opening_random_plies: int = 0,
    device=None,
) -> MatchResult:
    """Head-to-head A against B with balanced colours; returns A's result.

    The reference's eval recipe (``README.md:203``): the config's
    simulations, the most visited action, no exploration noise
    (``eval_mode``). Each network plays from its own engine, in bf16 like
    the self-play engines, on ``device`` (the card unless the CPU is asked
    for).

    Turn-alternating envs take the synchronized path: games of a round stay
    ply-synchronized (no slot resets), so each ply is ONE batched search by
    the mover's engine; colours balance through per-colour game quotas;
    finished slots are frozen; a game that reaches the move cap is a draw.
    Other envs take the general path: both engines search every position,
    each game takes the action of the engine owning its player to move,
    and finished slots restart with the colours swapped.

    ``opening_random_plies``: the first K plies of every game are uniform
    over the legal moves, the same for both rounds of a pair with the
    colours swapped, so that a deterministic search still plays a batch of
    distinct games.
    """
    env = make_env(cfg)
    if any(cfg.env_name.startswith(p) for p in _ALTERNATING):
        return _play_match_synchronized(env, cfg, network_a, network_b, num_games, seed,
                                        max_moves, opening_random_plies, device)
    engine_a = SelfPlayEngine(env, cfg, network_a, eval_mode=True, device=device, seed=seed)
    engine_b = SelfPlayEngine(env, cfg, network_b, eval_mode=True, device=device, seed=seed + 1)
    dev = engine_a.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = min(num_games, max(cfg.zero_num_parallel_games, 1))
    a_wins = b_wins = draws = played = moves = 0
    # A's colour per slot, alternating across the batch and per game
    a_colour = np.array([(i % 2) + 1 for i in range(batch)], np.int32)
    states = engine_a.init_batch(batch, gen)
    cap = max_moves or env.spec.max_game_length + 8
    while played < num_games and moves < cap * (num_games // batch + 2):
        out_a = engine_a.move(states, 1.0, gen)
        out_b = engine_b.move(states, 1.0, gen)
        use_a = torch.as_tensor(out_a.turn.cpu().numpy() == a_colour, device=dev)
        states = env.step(states, torch.where(use_a, out_a.action, out_b.action))
        done = env.is_terminal(states).cpu().numpy()
        moves += 1
        if not done.any():
            continue
        scores = env.eval_score(states).cpu().numpy()
        reset = np.zeros(batch, bool)
        for i in np.nonzero(done)[0]:
            if played >= num_games:
                break
            a_wins, b_wins, draws = _score(a_wins, b_wins, draws, float(scores[i]),
                                           a_colour[i] == 1)
            played += 1
            reset[i] = True
            a_colour[i] = 3 - a_colour[i]
        if reset.any():
            states = engine_a.reset_slots(states, torch.as_tensor(reset, device=dev), gen)
    return MatchResult(p1_wins=a_wins, p2_wins=b_wins, draws=draws)


def _random_openings(env, states, plies: int, generator: torch.Generator):
    """``plies`` uniform-random legal moves in every game."""
    for _ in range(plies):
        legal = env.legal_mask(states)
        weights = (legal | ~legal.any(-1, keepdim=True)).to(torch.float32)
        actions = torch.multinomial(weights, 1, generator=generator)[:, 0].to(torch.int32)
        states = env.step(states, actions)
    return states


def _play_match_synchronized(env, cfg, network_a, network_b, num_games: int, seed: int,
                             max_moves: Optional[int], opening_random_plies: int,
                             device) -> MatchResult:
    """The synchronized path of ``play_match``: rounds of ply-synchronized
    games, one search a ply by the mover's engine, the finished flags read
    on the host every ``PLIES_PER_CHECK`` plies."""
    engine_a = SelfPlayEngine(env, cfg, network_a, eval_mode=True, device=device, seed=seed)
    engine_b = SelfPlayEngine(env, cfg, network_b, eval_mode=True, device=device, seed=seed + 1)
    dev = engine_a.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = min(num_games, max(cfg.zero_num_parallel_games, 1))
    cap = max_moves or env.spec.max_game_length + 8
    max_plies = -(-cap // PLIES_PER_CHECK) * PLIES_PER_CHECK
    a_wins = b_wins = draws = played = 0
    round_idx = 0
    # per-colour game budgets, so that e.g. num_games <= batch still plays
    # half the games with A as P2, in a second round
    quota = {True: (num_games + 1) // 2, False: num_games // 2}
    with ProgressBar(num_games, "eval games ") as bar:
        while played < num_games:
            a_is_p1 = round_idx % 2 == 0
            round_idx += 1
            this_round = min(batch, quota[a_is_p1])
            if this_round <= 0:
                continue
            quota[a_is_p1] -= this_round
            states = engine_a.init_batch(batch, gen)
            if opening_random_plies > 0:
                # one opening seed per pair of rounds: the A-as-P1 and
                # A-as-P2 rounds start from the same openings, like twogtp
                pair = torch.Generator(device=dev).manual_seed(
                    seed * 1_000_003 + (round_idx - 1) // 2)
                states = _random_openings(env, states, opening_random_plies, pair)
            done = torch.zeros((batch,), dtype=torch.bool, device=dev)
            score = torch.zeros((batch,), dtype=torch.float32, device=dev)
            movers = (engine_a, engine_b) if a_is_p1 else (engine_b, engine_a)
            for ply in range(max_plies):
                out = movers[(ply + opening_random_plies) % 2].move(states, 1.0, gen)
                states = select_states(done, states, out.states)
                score = torch.where(done, score, out.eval_score)
                done = done | out.done
                if (ply + 1) % PLIES_PER_CHECK == 0 and bool(done.all()):
                    break
            # a game still running at the cap is a draw
            outcome = torch.where(done, score, 0.0)[:this_round].cpu().numpy()
            for s in outcome:
                a_wins, b_wins, draws = _score(a_wins, b_wins, draws, float(s), a_is_p1)
            played += this_round
            bar.step(this_round)
    return MatchResult(p1_wins=a_wins, p2_wins=b_wins, draws=draws)


def self_eval(cfg: Config, run_dir: str, interval: int = 1, num_games: int = 100,
              seed: int = 0, device=None) -> List[Dict]:
    """Ladder: checkpoint i + interval against checkpoint i over a training
    run's checkpoints, Elo accumulated (reference tools/self-eval.sh +
    eval.py)."""
    ckpts = _checkpoints(run_dir)
    model_dir = os.path.join(run_dir, "model")
    results = []
    elo = 0.0
    for i in range(0, len(ckpts) - interval, interval):
        na = load_checkpoint_variables(os.path.join(model_dir, ckpts[i + interval]), cfg)
        nb = load_checkpoint_variables(os.path.join(model_dir, ckpts[i]), cfg)
        r = play_match(cfg, na, nb, num_games=num_games, seed=seed + i, device=device)
        elo += elo_from_win_rate(r.p1_win_rate)
        results.append({
            "new": ckpts[i + interval], "old": ckpts[i],
            "win_rate": r.p1_win_rate, "elo": elo,
            "wins": r.p1_wins, "losses": r.p2_wins, "draws": r.draws,
        })
    return results


def fight_eval(cfg: Config, run_dir_a: str, run_dir_b: str, iteration: str,
               num_games: int = 100, seed: int = 0, device=None) -> Dict:
    """Two runs' checkpoints of the same name (``latest``: each run's
    newest) against each other (reference tools/fight-eval.sh)."""

    def resolve(run_dir: str) -> str:
        name = iteration if iteration != "latest" else _checkpoints(run_dir)[-1]
        return os.path.join(run_dir, "model", name)

    pa, pb = resolve(run_dir_a), resolve(run_dir_b)
    r = play_match(cfg, load_checkpoint_variables(pa, cfg), load_checkpoint_variables(pb, cfg),
                   num_games=num_games, seed=seed, device=device)
    return {
        "a": pa, "b": pb, "win_rate_a": r.p1_win_rate,
        "elo_diff": elo_from_win_rate(r.p1_win_rate),
        "wins": r.p1_wins, "losses": r.p2_wins, "draws": r.draws,
    }


def run_eval_cli(cfg: Config, args, device=None) -> int:
    """``-mode eval``: a cross-run match with ``-run_dir_b``
    (tools/fight-eval.sh:91-109), else the run's ladder, written to
    ``eval.csv``."""
    if getattr(args, "run_dir_b", ""):
        row = fight_eval(cfg, args.run_dir, args.run_dir_b,
                         getattr(args, "iteration", "") or "latest",
                         num_games=args.num_games, device=device)
        print(
            f"{row['a']} vs {row['b']}: win_rate_a={row['win_rate_a']:.3f} "
            f"elo_diff={row['elo_diff']:.1f} "
            f"({row['wins']}W/{row['losses']}L/{row['draws']}D)"
        )
        return 0
    results = self_eval(cfg, args.run_dir, num_games=args.num_games, device=device)
    for row in results:
        print(
            f"{row['new']} vs {row['old']}: win_rate={row['win_rate']:.3f} "
            f"elo={row['elo']:.1f} ({row['wins']}W/{row['losses']}L/{row['draws']}D)"
        )
    write_eval_outputs(args.run_dir, results)
    return 0


def write_eval_outputs(run_dir: str, results: List[Dict]) -> None:
    """``eval.csv``, and the Elo curve ``eval.png`` where matplotlib is
    installed (tools/eval.py:103-177)."""
    if not results:
        return
    with open(os.path.join(run_dir, "eval.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(results[0].keys()))
        w.writeheader()
        w.writerows(results)
    try:
        import matplotlib
    except ImportError:
        print("eval: matplotlib is not installed; eval.png skipped", file=sys.stderr)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps = [int(r["new"].split("_")[-1].split(".")[0]) for r in results]
    plt.figure(figsize=(7, 4))
    plt.plot(steps, [r["elo"] for r in results], marker="o")
    plt.xlabel("training step")
    plt.ylabel("Elo (accumulated)")
    plt.grid(True, alpha=0.3)
    plt.tight_layout()
    plt.savefig(os.path.join(run_dir, "eval.png"))
    plt.close()
