"""Mode-dispatch CLI (port of ``minizero_tpu/__main__.py``; reference
``minizero/console/mode_handler.cpp``).

    python -m minizero_tpu_torch -mode <mode> [-conf_file f] [-conf_str s] [-gen f]
                                 [-platform cpu]

Modes (``mode_handler.cpp:20-27``): ``console`` (GTP on stdin), ``sp``
(standalone self-play to a record file; for Atari over the host env, with
SD, LL and OBS record tags), ``zero`` (the zero training loop, continuing
from the run directory's newest checkpoint), ``env_test`` (random playout
and replay self-check), ``zero_training_name`` (the canonical run name),
``eval`` (a training run's checkpoint ladder, or two runs against each
other with ``-run_dir_b``), ``remove_obs`` / ``recover_obs`` (strip the OBS
tags of ``-input``'s records, or put them back by replaying each Atari
episode from its seed). ``-gen`` writes an annotated config file and exits.
Everything runs on the card unless ``-platform cpu`` asks for the CPU.

``-mode zero -multi_device`` trains data-parallel over ``torch.distributed``
(``parallel/``): under a launcher (``python -m torch.distributed.run
--nproc_per_node=N -m minizero_tpu_torch ...``) each process joins the
group, even a group of one; without one, with more than one visible card,
it spawns one process a card with a local rendezvous; with one card it runs
the plain loop.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import os
import sys

import numpy as np
import torch


def build_config(args):
    """The env's defaults, then the conf file, then the conf string (each
    env switch re-applies the new env's defaults first)."""
    from minizero_tpu_torch.config import default_config

    cfg = default_config()
    if args.conf_file:
        cfg = default_config(cfg.load_file(args.conf_file).env_name).load_file(args.conf_file)
    if args.conf_str:
        env_name = cfg.load_string(args.conf_str).env_name
        if env_name != cfg.env_name:
            cfg = default_config(env_name)
        cfg = cfg.load_string(args.conf_str)
    return cfg


def training_name(cfg) -> str:
    """reference ModeHandler::runZeroTrainingName (mode_handler.cpp:157-165):
    "{env}_{gumbel?}{az|mz}_{blocks}bx{channels}_n{sims}"."""
    alg = ("g" if cfg.actor_use_gumbel else "") + (
        "az" if cfg.nn_type_name == "alphazero" else "mz")
    name = cfg.env_name
    if cfg.env_board_size:
        name += f"_{cfg.env_board_size}x{cfg.env_board_size}"
    return f"{name}_{alg}_{cfg.nn_num_blocks}bx{cfg.nn_num_hidden_channels}_n{cfg.actor_num_simulation}"


def run_env_test(cfg, device=None) -> list:
    """Random playout and replay check (reference ModeHandler::runEnvTest,
    mode_handler.cpp:167-192): uniform legal moves drawn by numpy from
    ``program_seed`` until the game ends, then the same actions replayed
    from a fresh state must give the same state. Returns the actions."""
    from minizero_tpu_torch import resolve_device
    from minizero_tpu_torch.envs import make_env

    dev = resolve_device(device)
    env = make_env(cfg)
    rng = np.random.RandomState(cfg.program_seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.program_seed)
    state = env.init_random(1, gen, device=dev)
    actions = []
    for move in range(env.spec.max_game_length + 1):
        if bool(env.is_terminal(state)[0]):
            break
        legal = np.nonzero(env.legal_mask(state)[0].cpu().numpy())[0]
        assert len(legal) > 0, f"no legal action at move {move} (non-terminal)"
        a = int(rng.choice(legal))
        state = env.step(state, torch.tensor([a], dtype=torch.int32, device=dev))
        actions.append(a)
    print(f"played {len(actions)} moves; terminal={bool(env.is_terminal(state)[0])}; "
          f"eval={float(env.eval_score(state)[0]):g}")
    replay = env.init_random(1, gen, device=dev)
    for a in actions:
        replay = env.step(replay, torch.tensor([a], dtype=torch.int32, device=dev))
    for f in dataclasses.fields(state):
        if not torch.equal(getattr(state, f.name), getattr(replay, f.name)):
            raise AssertionError(f"replay determinism check failed: {f.name} differs")
    print("replay determinism check passed")
    return actions


def run_selfplay(cfg, num_games: int, output: str, device=None) -> None:
    """Standalone self-play: ``num_games`` finished games as records, one a
    line, to ``output`` (stdout when empty), with a seeded random net."""
    from minizero_tpu_torch import resolve_device
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.selfplay.collector import TrajectoryCollector
    from minizero_tpu_torch.selfplay.engine import SelfPlayEngine
    from minizero_tpu_torch.selfplay.record import serialize_game

    if cfg.env_name == "atari":
        run_selfplay_host(cfg, num_games, output, device=device)
        return
    dev = resolve_device(device)
    env = make_env(cfg)
    net = init_network(create_network(cfg, env.spec), seed=cfg.program_seed)
    engine = SelfPlayEngine(env, cfg, net, device=dev, seed=cfg.program_seed,
                            use_bf16=dev.type == "cuda")
    batch = cfg.zero_num_parallel_games
    collector = TrajectoryCollector(cfg, env.spec, batch, seed=cfg.program_seed)
    states = engine.init_batch(batch)
    enable = torch.as_tensor(collector.enable_resign_flags(), device=dev)
    msr = None
    scan_moves = max(1, int(cfg.zero_moves_per_dispatch))
    done = 0
    out = open(output, "w") if output else sys.stdout
    try:
        while done < num_games:
            stacked, states, enable, msr = engine.move_scan(states, 1.0, scan_moves, enable, msr)
            for fg in collector.add_scan(stacked):
                if done >= num_games:
                    break
                out.write(serialize_game(env.spec.name, fg.record, env.spec.board_size,
                                         fg.players) + "\n")
                done += 1
    finally:
        if output:
            out.close()
    print(f"wrote {done} games", file=sys.stderr)


def run_selfplay_host(cfg, num_games: int, output: str, ale_factory=None, device=None) -> None:
    """Standalone self-play over the host (ALE) env: ``num_games`` records
    (chunks of long episodes count one each) with SD, OFF, LL and, with
    ``zero_actor_record_observations``, OBS tags, one a line, to ``output``
    (stdout when empty), with a seeded random net. ``ale_factory(seed)``
    builds the ALE handles (default: ``ale_py``'s)."""
    from minizero_tpu_torch import resolve_device
    from minizero_tpu_torch.envs.atari import AtariVecEnv
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.selfplay.host_engine import (
        AtariTrajectoryCollector, HostSelfPlayEngine, atari_record_line)

    dev = resolve_device(device)
    batch = cfg.zero_num_parallel_games
    vec = AtariVecEnv(batch, seed=cfg.program_seed, game_name=cfg.env_atari_name,
                      rom_dir=cfg.env_atari_rom_dir, ale_factory=ale_factory)
    net = init_network(create_network(cfg, vec.spec), seed=cfg.program_seed)
    engine = HostSelfPlayEngine(vec, cfg, net, device=dev, seed=cfg.program_seed,
                                use_bf16=dev.type == "cuda")
    collector = AtariTrajectoryCollector(cfg, vec.spec, batch)
    done = 0
    out = open(output, "w") if output else sys.stdout
    try:
        while done < num_games:
            finished, reset_slots = collector.add_moves(engine.move())
            for fg in finished:
                if done >= num_games:
                    break
                out.write(atari_record_line(vec.spec, fg, vec.envs[fg.slot].seed,
                                            cfg.zero_actor_record_observations) + "\n")
                done += 1
            if reset_slots:
                vec.reset_done()
    finally:
        if output:
            out.close()
    print(f"wrote {done} games", file=sys.stderr)


def _device_for(platform: str):
    """``-platform``: ``cpu`` runs on the CPU; empty, ``gpu`` or ``cuda``
    on the card."""
    if platform == "cpu":
        return "cpu"
    if platform in ("", "gpu", "cuda"):
        return None
    raise ValueError(f"-platform {platform}: expected cpu, gpu or cuda")


def main(argv=None, device=None) -> int:
    """The CLI; ``device`` (for callers such as the tests) takes the place
    of ``-platform``."""
    parser = argparse.ArgumentParser(prog="minizero_tpu_torch")
    parser.add_argument("-mode", default="console",
                        choices=["console", "sp", "zero", "env_test", "zero_training_name",
                                 "eval", "remove_obs", "recover_obs"])
    parser.add_argument("-conf_file", default="")
    parser.add_argument("-conf_str", default="")
    parser.add_argument("-gen", default="", help="generate an annotated config file and exit")
    parser.add_argument("-num_games", type=int, default=100)
    parser.add_argument("-input", default="")
    parser.add_argument("-output", default="")
    parser.add_argument("-run_dir", default="training_result")
    parser.add_argument("-run_dir_b", default="",
                        help="second run dir: eval mode plays the two runs' checkpoints "
                             "against each other (reference tools/fight-eval.sh)")
    parser.add_argument("-iteration", default="",
                        help="checkpoint file name for the cross-run eval (default: latest)")
    parser.add_argument("-multi_device", action="store_true",
                        help="zero mode: data-parallel over every visible card, or over the "
                             "ranks of a torch.distributed launcher")
    parser.add_argument("-platform", default="", help="cpu, or gpu / cuda (the default)")
    args = parser.parse_args(argv)
    if device is None:
        device = _device_for(args.platform)

    cfg = build_config(args)
    if cfg.program_quiet:
        # silence diagnostic output like the reference's cerr redirect
        # (console/mode_handler.cpp:61); GTP replies and mode outputs stay
        # on stdout
        devnull = open(os.devnull, "w")
        sys.stderr = devnull
        atexit.register(devnull.close)
    if args.gen:
        cfg.save_file(args.gen)
        print(f"wrote {args.gen}")
        return 0
    if args.mode == "zero_training_name":
        print(training_name(cfg))
    elif args.mode == "env_test":
        run_env_test(cfg, device)
    elif args.mode == "console":
        from minizero_tpu_torch.console.gtp import GTPConsole

        GTPConsole(cfg, device=device).run()
    elif args.mode == "sp":
        run_selfplay(cfg, args.num_games, args.output, device)
    elif args.mode == "eval":
        from minizero_tpu_torch.eval.match import run_eval_cli

        return run_eval_cli(cfg, args, device)
    elif args.mode == "remove_obs":
        from minizero_tpu_torch.tools.obs import remove_obs_file

        n = remove_obs_file(args.input, args.output or args.input + ".noobs")
        print(f"stripped OBS from {n} records")
    elif args.mode == "recover_obs":
        # deterministic seed replay through the env (reference
        # obs_recover.h:19-83); Atari's real ALE needs the ale_py package
        from minizero_tpu_torch.tools.obs import AtariObsReplayer, recover_obs_file

        replayer = AtariObsReplayer(rom_dir=cfg.env_atari_rom_dir)
        n = recover_obs_file(args.input, args.output or args.input + ".obs", replayer)
        print(f"recovered OBS for {n} records")
    else:
        return run_zero(cfg, args, argv, device)
    return 0


def run_zero(cfg, args, argv, device=None) -> int:
    """``-mode zero``: the loop, continuing from the run directory's newest
    checkpoint; with ``-multi_device`` one rank of a data-parallel run."""
    from minizero_tpu_torch.parallel.distributed import init_distributed, under_launcher
    from minizero_tpu_torch.parallel.mesh import make_mesh
    from minizero_tpu_torch.zero.loop import ZeroLoop

    mesh = None
    if args.multi_device:
        if under_launcher():
            init_distributed(device=device)
            mesh = make_mesh(device=device)
        elif device is None and torch.cuda.device_count() > 1:
            spawn_ranks(sys.argv[1:] if argv is None else argv, torch.cuda.device_count())
            return 0
    loop = ZeroLoop(cfg, args.run_dir, device=device, mesh=mesh)
    try:
        loop.resume()  # continue mode when the run dir has checkpoints
        loop.run()
    finally:
        loop.close()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, argv, world: int, port: int, device) -> None:
    """One spawned rank: the launcher's variables, one torch thread, then
    the CLI again, which joins the group."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    main(argv, device=device)


def spawn_ranks(argv, world: int, device=None) -> None:
    """Run the CLI as ``world`` local ranks (one a card; ``device="cpu"``
    for gloo ranks on the CPU) with a rendezvous on a free local port;
    returns when every rank has finished, and raises if one failed."""
    torch.multiprocessing.spawn(_rank_main, args=(list(argv), world, _free_port(), device),
                                nprocs=world, join=True)


if __name__ == "__main__":
    sys.exit(main())
