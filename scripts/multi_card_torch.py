"""The data-parallel zero loop and the split dense heads of the PyTorch port
across four cards over NCCL, one rank a card, held step for step against
one card.

    python3 scripts/multi_card_torch.py OUT_DIR [PARTS]

It needs four visible CUDA cards and exits non-zero at once with fewer: no
part falls back to fewer ranks, to gloo or to the CPU. ``OUT_DIR`` (e.g.
``out/multi_card``) receives each process's log and every JSON
line; the runs themselves go under ``_runs/multi_card/`` (git-ignored).
``PARTS`` is a comma-separated subset of ``a,b,c,d,e,f,w`` (default all;
they run as ``SCHEDULE`` orders them, (c) and (e) side by side); (c) reads
(b)'s records and (f) (a)'s checkpoints.

The configuration is ``scripts/zero_recipe_torch.py``'s ``RECIPE``
(``runs/go9_gaz_full.cfg``): Go 9x9 Gumbel AlphaZero n=16, a net of 1
block x 256 channels (value head 256), 1,024 games in lock-step, 2,000
games and 500 SGD steps at global batch 1,024 an iteration,
``program_seed=0``. Over four ranks each card plays 256 games in
lock-step and 500 games an iteration, and trains on 256 rows a step.

(a) The CLI's own spawn: ``python -m minizero_tpu_torch -mode zero
    -multi_device`` with no launcher variables, iterations 1-2, then the
    same command to iteration 4, which resumes. Checked from outside: exit
    0, four shards of 500 games an iteration, the global ``Training.log``
    lines at 2,000 games, one checkpoint an iteration, the resume line of
    every rank, and ``nvidia-smi --query-compute-apps`` during the first
    call: one process on each card.
(b) The same run under ``torch.distributed.run --nproc_per_node=4``, each
    rank calling the CLI's ``main`` with the loop's methods wrapped: NCCL,
    a world of 4, ``cuda:rank``; B1 17 launches a move and B1', B2, B3
    none; finite losses; the window holding the rank's own games of each
    iteration; after every iteration a digest of the parameters, the
    running statistics and the optimizer's momentum all-gathered and equal
    on the four ranks; on resume each rank's rebuilt window and state equal
    to its digest at the end of the first process. Per iteration and rank:
    self-play seconds and their split, moves, SGD ms a step by CUDA events
    from step 11, peak device memory, host RSS. Once: the gradient
    all-reduce's bytes a step and one such all-reduce timed alone.
(c) Step parity: one global batch of 1,024 rows sampled from (b)'s last
    records, float32, TF32 off, the same weights and rotations, through the
    dp-4 sharded step on four cards and the plain step
    (``learner/train.make_train_step``) on card 0: parameters and scalar
    metrics within 1e-5 after 1 step and 1e-4 after 10, the four ranks
    bitwise equal; for gaz and for gmz (``RECIPE_GMZ``'s net, K=5). After
    10 steps the limit widens to 4x one card's own spread where that is
    wider than 1e-4 (``plain_parity`` says why).
(d) dp 2 x mp 2: ``ZeroLoop(cfg, run_dir, mesh=make_mesh(model_parallel=2))``
    on four NCCL ranks, iterations 1-2, then a resume to 3: the ranks'
    coordinates, the local heads (policy 82 -> 41, value hidden 256 -> 128),
    the two ranks of each ``mp`` group playing the same games (a digest of
    each iteration's games all-gathered over the group), the files of
    ``mp`` rank 0 only, a checkpoint of whole heads that loads into a plain
    one-card ``ZeroLoop``, the split step against one card as in (c), and
    the heads' gathers timed alone.
(e) The watchdog on NCCL: a dp-4 run with ``zero_collective_timeout=30``
    in which rank 3 sleeps 120 s before its first statistics gather; ranks
    0-2 must exit with ``WATCHDOG_EXIT_CODE`` (42) 30-75 s after they
    entered the gather, with the ``[Watchdog]`` line.
(f) (a)'s step-2,000 net against its step-0 net on card 0: 96 games at
    ``scripts/elo_curve.py``'s protocol; fails unless wins exceed losses.
(w) Weak scaling, reported only: one iteration on card 0 alone, then one
    dp-4 iteration at 4,096 games in lock-step and 8,000 games (500 steps
    at global batch 1,024), with ``os.cpu_count()`` and the affinity.

Every part runs; a failed part is reported and the script exits 1 at the
end. The last line is the summary: the parts, each card's name and power
limit and ``nvidia-smi topo -m``.
"""
import copy
import hashlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import zero_recipe_torch as zr  # noqa: E402

WORLD = 4
GAMES = 2000  # an iteration's games (RECIPE)
STEPS = 500  # an iteration's SGD steps (RECIPE)
RUN_ROOT = os.path.join(ROOT, "_runs", "multi_card")
PARTS = "abcdefw"
# the order the parts run in; (c) and (e), which check and time nothing
# that the other loads, side by side
SCHEDULE = (("a",), ("b",), ("c", "e"), ("d",), ("f",), ("w",))
CALL_TIMEOUT = 600  # a process's limit, seconds
LAUNCHER_VARIABLES = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                      "MASTER_PORT", "GROUP_RANK", "ROLE_RANK", "TORCHELASTIC_RUN_ID")
# (c), (d): steps after which the dp step is held to one card, and the tolerance
PARITY = {1: 1e-5, 10: 1e-4}
PARITY_BATCH = 1024
PARITY_SEED = 23
REORDERINGS = 2  # plain runs on the batch's rows in other orders
SPREAD_FACTOR = 4  # after 10 steps: the limit over one card's reordered spread
HEAD_GATHERS = {"policy": 82, "value_hidden": 256}  # the split layers' output widths
# (e)
WATCHDOG_S = 30
WEDGE_S = 120
WATCHDOG_WINDOW = (30.0, 75.0)
WEDGE_CONF = (f"zero_end_iteration=1:zero_num_parallel_games=256:"
              f"zero_num_games_per_iteration=256:zero_collective_timeout={WATCHDOG_S}")
# (w)
WEAK_CONF = "zero_end_iteration=1:zero_num_parallel_games=4096:zero_num_games_per_iteration=8000"


class Failure(Exception):
    pass


def config(recipe: str = "gaz"):
    return zr.recipe_config(recipe=recipe)


def shard(rank: int) -> str:
    return "" if rank == 0 else f".p{rank}"


def gathered(value, group=None) -> list:
    """``value`` of every rank of ``group`` (the default group: all), in
    rank order."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, value, group=group)
    return out


def games_digest(records) -> str:
    """The games as played: actions, search policies and results."""
    h = hashlib.sha1()
    for rec in records:
        for a in (rec.actions, rec.policy):
            h.update(memoryview(np.ascontiguousarray(a).tobytes()))
        h.update(repr(float(rec.result)).encode())
    return h.hexdigest()


def mp_games_agree(mesh, records) -> list:
    """The digests of ``records`` over this rank's ``mp`` group (a
    collective of the group); the group agrees when they are all equal."""
    return gathered(games_digest(records), mesh.mp_group)


def emit(line: dict) -> None:
    """One JSON line in one write, so that ranks sharing a pipe do not cut
    into each other's lines."""
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()


def json_objects(line: str) -> list:
    """The JSON objects of an output line (several where ranks' lines ran
    together)."""
    out, i, dec = [], line.find("{"), json.JSONDecoder()
    while i >= 0:
        try:
            obj, end = dec.raw_decode(line, i)
        except ValueError:
            i = line.find("{", i + 1)
            continue
        if isinstance(obj, dict):
            out.append(obj)
        i = line.find("{", end)
    return out


# -------------------------------------------------------------------- parent

def clean_env() -> dict:
    return {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARIABLES}


def fresh(name: str) -> str:
    path = os.path.join(RUN_ROOT, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def run_logged(cmd, log_path: str, timeout: float = CALL_TIMEOUT, env=None, poll=None):
    """Run ``cmd`` in a process group of its own, its output into
    ``log_path`` and its JSON lines echoed; ``poll()`` every 2 s while it
    runs. Returns (exit code, JSON lines, seconds); a time-out kills the
    group and fails."""
    t = time.perf_counter()
    lines = []
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env or clean_env(), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, start_new_session=True)

        def read():
            for line in proc.stdout:
                log.write(line)
                found = json_objects(line)
                for obj in found:
                    emit(obj)
                lines.extend(found)

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        while proc.poll() is None:
            if time.perf_counter() - t > timeout:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                raise Failure(f"{cmd[:6]} did not end within {timeout} s (log {log_path})")
            if poll is not None:
                poll()
            time.sleep(2)
        reader.join()
    return proc.returncode, lines, time.perf_counter() - t


def tail(path: str, n: int = 3000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def torchrun(part: str, args: dict, log_path: str, timeout: float = CALL_TIMEOUT):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={WORLD}", os.path.abspath(__file__), "--rank", part,
           json.dumps(args)]
    rc, lines, seconds = run_logged(cmd, log_path, timeout)
    if rc != 0:
        raise Failure(f"({part}) torch.distributed.run exited {rc}:\n{tail(log_path)}")
    return lines, seconds


def cli_cmd(conf: str, run_dir: str, conf_str: str, multi: bool = True):
    return ([sys.executable, "-m", "minizero_tpu_torch", "-mode", "zero"]
            + (["-multi_device"] if multi else [])
            + ["-conf_file", conf, "-conf_str", conf_str, "-run_dir", run_dir])


def smi(*query: str) -> list:
    out = subprocess.run(["nvidia-smi", *query], capture_output=True, text=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def check_run_dir(run_dir: str, end: int, rows: int, games: int, steps: int,
                  resumed_at=None) -> dict:
    """A ``rows``-row run directory after iteration ``end``: ``rows`` shards
    of ``games // rows`` records an iteration and no other file of a rank,
    one global ``Training.log`` line an iteration at ``games`` games and
    ``rows`` hosts, one checkpoint an iteration, and (``resumed_at``) each
    row's resume line for its own shards. Returns the global lines."""
    per_row = games // rows
    sgf = os.path.join(run_dir, "sgf")
    want = {f"{it}{shard(r)}.sgf" for it in range(1, end + 1) for r in range(rows)}
    if set(os.listdir(sgf)) != want:
        raise Failure(f"{run_dir}: record files {sorted(os.listdir(sgf))}, expected {sorted(want)}")
    for name in sorted(want):
        n = sum(1 for ln in open(os.path.join(sgf, name)) if ln.strip())
        if n != per_row:
            raise Failure(f"{run_dir}: sgf/{name} holds {n} records, expected {per_row}")
    extra = [f for f in os.listdir(run_dir) if any(f".p{r}." in f for r in range(rows, 8))]
    if extra:
        raise Failure(f"{run_dir}: files of ranks past row {rows - 1}: {extra}")
    ckpts = sorted(os.listdir(os.path.join(run_dir, "model")))
    want_ckpts = sorted(f"weight_iter_{it * steps}.ckpt" for it in range(end + 1))
    if ckpts != want_ckpts:
        raise Failure(f"{run_dir}: checkpoints {ckpts}, expected {want_ckpts}")
    log = open(os.path.join(run_dir, "Training.log")).read().splitlines()
    lines = {}
    for it in range(1, end + 1):
        found = [ln.split("] ", 1)[1] for ln in log
                 if f"[Iteration] {it}: self-play {games} games in" in ln
                 and f"{rows} hosts)" in ln]
        if len(found) != 1:
            raise Failure(f"{run_dir}: {len(found)} global lines of iteration {it} at {games} "
                          f"games and {rows} hosts")
        lines[it] = found[0]
    if resumed_at is not None:
        want_line = f"[Resume] iteration {resumed_at}, {resumed_at * per_row} games reloaded"
        for r in range(rows):
            text = open(os.path.join(run_dir, f"Training{shard(r)}.log")).read()
            if want_line not in text or "dealt over" in text:
                raise Failure(f"{run_dir}: Training{shard(r)}.log lacks '{want_line}'")
    return lines


def part_a(conf: str, out: str) -> dict:
    run_dir = fresh("a")
    apps = []

    def watch():
        if len(apps) < WORLD:
            rows = smi("--query-compute-apps=pid,gpu_uuid,used_memory", "--format=csv")[1:]
            if len(rows) > len(apps):
                apps[:] = rows

    res = {"calls": []}
    for i, end in enumerate((2, 4), 1):
        log = os.path.join(out, f"a_call{i}.log")
        rc, _, seconds = run_logged(cli_cmd(conf, run_dir, f"zero_end_iteration={end}"), log,
                                    poll=watch if i == 1 else None)
        if rc != 0:
            raise Failure(f"(a) call {i} (to iteration {end}) exited {rc}:\n{tail(log)}")
        lines = check_run_dir(run_dir, end, WORLD, GAMES, STEPS,
                              resumed_at=2 if i == 2 else None)
        res["calls"].append({"end_iteration": end, "seconds": seconds, "global_lines": lines})
    cards = [ln.split(",")[1].strip() for ln in smi("--query-gpu=index,uuid",
                                                    "--format=csv,noheader")]
    res["compute_apps"] = apps
    if sorted(ln.split(",")[1].strip() for ln in apps) != sorted(cards[:WORLD]):
        raise Failure(f"(a) nvidia-smi's compute processes {apps} are not one on each of the "
                      f"cards {cards}")
    shutil.copy(os.path.join(run_dir, "Training.log"), os.path.join(out, "a_Training.log"))
    return res


def part_b(conf: str, out: str) -> dict:
    run_dir = fresh("b")
    res = {"processes": []}
    for i, end in enumerate((2, 4), 1):
        lines, seconds = torchrun("b", {"run_dir": run_dir, "conf": conf, "end": end,
                                        "index": i}, os.path.join(out, f"b_process{i}.log"))
        done = [ln for ln in lines if ln.get("done") == "b"]
        if sorted(ln["rank"] for ln in done) != list(range(WORLD)):
            raise Failure(f"(b) process {i}: ranks done {done}")
        res["processes"].append({"end_iteration": end, "seconds": seconds})
    res["global_lines"] = check_run_dir(run_dir, 4, WORLD, GAMES, STEPS, resumed_at=2)
    for r in range(WORLD):
        shutil.copy(os.path.join(run_dir, f"Training{shard(r)}.log"),
                    os.path.join(out, f"b_Training{shard(r)}.log"))
    return res


def part_c(conf: str, out: str) -> dict:
    sgf = os.path.join(RUN_ROOT, "b", "sgf")
    if not os.path.exists(os.path.join(sgf, "4.sgf")):
        raise Failure("(c) needs (b)'s records of iteration 4")
    work = fresh("c")
    _, seconds = torchrun("c", {"sgf": sgf, "iteration": 4, "out": work},
                          os.path.join(out, "c_parity.log"), timeout=300)
    return {"seconds": seconds, "parity": [plain_parity(os.path.join(work, f"parity_{r}_dp4.pt"))
                                           for r in ("gaz", "gmz")]}


def part_d(conf: str, out: str) -> dict:
    run_dir = fresh("d")
    lines, seconds = torchrun("d", {"run_dir": run_dir, "conf": conf},
                              os.path.join(out, "d_mp2.log"))
    done = [ln for ln in lines if ln.get("done") == "d"]
    if sorted(ln["rank"] for ln in done) != list(range(WORLD)):
        raise Failure(f"(d): ranks done {done}")
    global_lines = check_run_dir(run_dir, 3, WORLD // 2, GAMES, STEPS, resumed_at=2)
    parity = [plain_parity(os.path.join(RUN_ROOT, f"parity_{r}_dp2_mp2.pt"))
              for r in ("gaz", "gmz")]
    return {"seconds": seconds, "global_lines": global_lines, "parity": parity}


def part_e(conf: str, out: str) -> dict:
    """Four processes with the launcher's variables (not under
    ``torch.distributed.run``, whose agent would stop the other ranks at
    the first exit): ranks 0-2 must leave by the watchdog."""
    from minizero_tpu_torch.parallel.watchdog import WATCHDOG_EXIT_CODE

    run_dir = fresh("e")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs, logs = [], []
    t0 = time.time()
    for r in range(WORLD):
        env = clean_env()
        env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                   LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost", MASTER_PORT=port,
                   OMP_NUM_THREADS="1")
        logs.append(os.path.join(out, f"e_rank{r}.log"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", "e",
             json.dumps({"run_dir": run_dir, "conf": conf})],
            cwd=ROOT, env=env, stdout=open(logs[-1], "w"), stderr=subprocess.STDOUT))
    exits = {}
    try:
        while len(exits) < WORLD - 1 and time.time() - t0 < 300:
            for r in range(WORLD - 1):
                if r not in exits and procs[r].poll() is not None:
                    exits[r] = (procs[r].returncode, time.time())
            time.sleep(0.25)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    res = {"ranks": []}
    text3 = open(logs[WORLD - 1]).read()
    if "RANK_3_WEDGED" not in text3:
        raise Failure(f"(e) rank 3 never wedged:\n{text3[-3000:]}")
    for r in range(WORLD - 1):
        text = open(logs[r]).read()
        if r not in exits:
            raise Failure(f"(e) rank {r} still running after 300 s:\n{text[-3000:]}")
        rc, at = exits[r]
        entries = [obj["gather_entry"] for ln in text.splitlines() for obj in json_objects(ln)
                   if "gather_entry" in obj]
        if not entries:
            raise Failure(f"(e) rank {r} exited {rc} before its gather:\n{text[-3000:]}")
        waited = at - entries[0]
        res["ranks"].append({"rank": r, "exit": rc, "seconds_after_gather": waited})
        if rc != WATCHDOG_EXIT_CODE or "[Watchdog]" not in text or "RANK_DONE" in text:
            raise Failure(f"(e) rank {r} exited {rc}, expected {WATCHDOG_EXIT_CODE} with the "
                          f"[Watchdog] line:\n{text[-3000:]}")
        if not WATCHDOG_WINDOW[0] <= waited <= WATCHDOG_WINDOW[1]:
            raise Failure(f"(e) rank {r} left {waited:.1f} s after its gather, outside "
                          f"{WATCHDOG_WINDOW}")
    res["watchdog_line"] = next(ln for ln in open(logs[0]).read().splitlines()
                                if "[Watchdog]" in ln)
    return res


def part_f(conf: str, out: str) -> dict:
    import torch

    from minizero_tpu_torch.eval.match import load_checkpoint_variables

    cfg = config()
    model = os.path.join(RUN_ROOT, "a", "model")
    last = 4 * cfg.learner_training_step
    paths = [os.path.join(model, f"weight_iter_{s}.ckpt") for s in (last, 0)]
    if not all(os.path.exists(p) for p in paths):
        raise Failure(f"(f) needs (a)'s checkpoints {paths}")
    mcfg = cfg.replace(zero_num_parallel_games=zr.MATCH_GAMES)
    a, b = (load_checkpoint_variables(p, mcfg) for p in paths)
    r = zr.match(mcfg, a, b, zr.MATCH_GAMES, None, "cuda", zr.MATCH_SEED)
    r.update(pair=f"(a) step {last} vs step 0", card=torch.cuda.get_device_name(0))
    emit({"part": "f", **r})
    if r["wins"] <= r["losses"]:
        raise Failure(f"(f) step {last} against step 0: {r['wins']}-{r['losses']}-{r['draws']}")
    return r


def iteration_of(run_dir: str) -> dict:
    """Rank 0's perf row and the global Training.log line of iteration 1."""
    perf = json.loads(open(os.path.join(run_dir, "perf.jsonl")).readline())
    line = next(ln.split("] ", 1)[1] for ln in open(os.path.join(run_dir, "Training.log"))
                if "[Iteration] 1:" in ln)
    return {"selfplay_s": perf["selfplay_s"], "optimize_s": perf["optimize_s"],
            "iteration_s": perf["selfplay_s"] + perf["optimize_s"],
            "games_per_s": float(line.split("(")[1].split(" games/s")[0]), "line": line}


def part_w(conf: str, out: str) -> dict:
    one = fresh("w1")
    rc, _, s1 = run_logged(cli_cmd(conf, one, "zero_end_iteration=1", multi=False),
                           os.path.join(out, "w_one_card.log"))
    if rc != 0:
        raise Failure(f"(w) one card exited {rc}:\n{tail(os.path.join(out, 'w_one_card.log'))}")
    four = fresh("w4")
    rc, _, s4 = run_logged(cli_cmd(conf, four, WEAK_CONF), os.path.join(out, "w_four_cards.log"))
    if rc != 0:
        raise Failure(f"(w) four cards exited {rc}:\n{tail(os.path.join(out, 'w_four_cards.log'))}")
    res = {"one_card": dict(iteration_of(one), games=GAMES, lock_step=1024, command_s=s1),
           "four_cards": dict(iteration_of(four), games=8000, lock_step=4096,
                              command_s=s4),
           "cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0))}
    res["games_per_s_ratio"] = res["four_cards"]["games_per_s"] / res["one_card"]["games_per_s"]
    emit({"part": "w", **res})
    return res


def main(out_dir: str, parts: str = PARTS) -> int:
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < WORLD:
        print(f"multi_card_torch: needs {WORLD} CUDA cards, found {n}", file=sys.stderr)
        return 2
    out = os.path.abspath(out_dir)
    os.makedirs(out, exist_ok=True)
    os.makedirs(RUN_ROOT, exist_ok=True)
    conf = os.path.join(RUN_ROOT, "recipe.cfg")
    config().save_file(conf)
    shutil.copy(conf, os.path.join(out, "recipe.cfg"))
    steps = {"a": part_a, "b": part_b, "c": part_c, "d": part_d, "e": part_e, "f": part_f,
             "w": part_w}
    results, failures = {}, {}

    def run(p):
        t = time.perf_counter()
        try:
            results[p] = steps[p](conf, out)
            results[p]["part_s"] = time.perf_counter() - t
            emit({"part": p, "passed": True, "seconds": results[p]["part_s"]})
        except Failure as e:
            failures[p] = str(e)
            print(f"multi_card_torch: part ({p}) FAILED: {e}", file=sys.stderr, flush=True)
            emit({"part": p, "passed": False, "seconds": time.perf_counter() - t,
                  "failure": str(e)[-2000:]})

    t0 = time.perf_counter()
    wanted = parts.replace(",", "")
    for group in SCHEDULE:
        threads = [threading.Thread(target=run, args=(p,)) for p in group if p in wanted]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        with open(os.path.join(out, "results.json"), "w") as f:
            json.dump({"results": results, "failures": failures}, f, indent=1, default=str)
    emit({"summary": "multi_card", "passed": sorted(results), "failed": sorted(failures),
          "seconds": time.perf_counter() - t0,
          "cards": smi("--query-gpu=name,power.limit", "--format=csv,noheader"),
          "topology": smi("topo", "-m"), "cpu_count": os.cpu_count(),
          "affinity": len(os.sched_getaffinity(0))})
    return 1 if failures else 0


# --------------------------------------------------------------------- ranks

def join():
    """This rank in the launcher's group, on its own card (NCCL)."""
    from minizero_tpu_torch.parallel.distributed import init_distributed

    return init_distributed()


def check_rank(device) -> int:
    """Fails unless this rank runs on NCCL in a world of 4 on card
    ``rank``; returns the rank."""
    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    seen = (dist.get_backend(), dist.get_world_size(), str(device), torch.cuda.current_device())
    if seen != ("nccl", WORLD, f"cuda:{rank}", rank):
        raise Failure(f"rank {rank} runs as (backend, world, device, current card) {seen}")
    return rank


def kernel_counts():
    from minizero_tpu_torch.ops.gather_rows import gather_rows
    from minizero_tpu_torch.ops.tree_kernel import fused_tree_step
    from minizero_tpu_torch.ops.tree_kernel_v2 import fused_tree_step_v2

    return (fused_tree_step.launches, fused_tree_step.launches_rewards,
            fused_tree_step_v2.launches, gather_rows.launches)


def check_launches(before, moves: int, sims: int, what: str) -> dict:
    b1, b1r, b2, b3 = (a - b for a, b in zip(kernel_counts(), before))
    launches = {"tree_step": b1, "tree_step_rewards": b1r, "tree_step_v2": b2, "gather_rows": b3}
    if b1 != moves * (sims + 1) or b1r or b2 or b3 or not moves:
        raise Failure(f"{what}: launches {launches} over {moves} moves")
    return launches


def time_collective(fn, reps: int = 50) -> float:
    """ms per call of ``fn`` (a collective) by CUDA events, after 5 warm
    calls."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rank_b(a: dict) -> None:
    """One rank of (b): the CLI's ``main`` with the loop's methods wrapped."""
    import torch
    import torch.distributed as dist

    from minizero_tpu_torch.__main__ import main as cli
    from minizero_tpu_torch.learner.replay import ReplayBuffer
    from minizero_tpu_torch.parallel import distributed as pd
    from minizero_tpu_torch.zero import loop as zl

    join()
    run_dir, index = a["run_dir"], a["index"]
    rank = dist.get_rank()
    loops, timers, now, it = [], [], {"iteration": 0}, {}
    make_step = pd.make_sharded_train_step

    def timed_step(*args, **kwargs):
        timers.append(zr.StepEvents(make_step(*args, **kwargs), True))
        return timers[-1]

    init, resume = zl.ZeroLoop.__init__, zl.ZeroLoop.resume
    self_play, optimize = zl.ZeroLoop.self_play_iteration, zl.ZeroLoop.optimize_iteration
    log_metrics, add_game = zl.ZeroLoop._log_metrics, ReplayBuffer.add_game

    def tagged_add(self, record):
        record.iteration = now["iteration"]
        add_game(self, record)

    def wrapped_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        check_rank(self.device)
        if self.is_main != (rank == 0):
            raise Failure(f"rank {rank}: is_main {self.is_main}")
        loops.append(self)

    def wrapped_resume(self):
        t = time.perf_counter()
        now["iteration"] = -1
        start = resume(self)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        for g in self.buffer.games:
            g.reloaded = True
        path = os.path.join(run_dir, f"digest_rank{rank}_step{self.state.step}.json")
        line = {"part": "b", "rank": rank, "process": index, "resumed_iteration": start,
                "resume_s": seconds, "resume_games": len(self.buffer)}
        if start > 0:
            want = json.load(open(path))
            got = [zr.game_digest(g) for g in self.buffer.games]
            if got != want["games"]:
                bad = sum(x != y for x, y in zip(got, want["games"]))
                raise Failure(f"rank {rank}: resume rebuilt {len(got)} games against "
                              f"{len(want['games'])}, {bad} different")
            if zr.state_digest(self) != want["state"]:
                raise Failure(f"rank {rank}: the resumed state differs from the first process's")
            for g, tag in zip(self.buffer.games, want["iterations"]):
                g.iteration = tag
            line.update(games_equal=True, state_equal=True)
        emit(line)
        return start

    def wrapped_log_metrics(self, step, sums, n):
        it["losses"] = {k: float(v) / n for k, v in sums.items()}
        return log_metrics(self, step, sums, n)

    def wrapped_self_play(self, iteration):
        now["iteration"] = iteration
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kernel_counts()
        t = time.perf_counter()
        stats = self_play(self, iteration)
        torch.cuda.synchronize()
        timing = dict(self.last_selfplay_timing)
        moves = timing["chunks"] * timing["moves_per_chunk"]
        it.update(part="b", rank=rank, iteration=iteration, process=index,
                  selfplay_s=time.perf_counter() - t, timing=timing, moves=moves,
                  global_games=stats["games"], global_selfplay_s=stats["time_s"],
                  launches=check_launches(before, moves, self.engine.spec.num_simulations,
                                          f"rank {rank} iteration {iteration}"))
        if stats["games"] != GAMES:
            raise Failure(f"rank {rank} iteration {iteration}: {stats['games']} games in all")
        return stats

    def wrapped_optimize(self, iteration):
        out = optimize(self, iteration)
        cfg = self.cfg
        ms = timers[-1].take()
        losses = it.pop("losses", {})
        if not losses or not np.isfinite(list(losses.values())).all():
            raise Failure(f"rank {rank} iteration {iteration}: losses {losses}")
        tags = [g.iteration for g in self.buffer.games]
        lo = max(1, iteration - cfg.zero_replay_buffer + 1)
        per_rank = -(-GAMES // WORLD)
        want = [i for i in range(lo, iteration + 1) for _ in range(per_rank)]
        if tags != want:
            raise Failure(f"rank {rank} iteration {iteration}: the window holds the games of "
                          f"iterations {sorted(set(tags))} ({len(tags)} games)")
        digests = gathered(zr.state_digest(self))
        if len(set(digests)) != 1:
            raise Failure(f"rank {rank} iteration {iteration}: the ranks' parameters and "
                          f"momentum differ: {digests}")
        it.update(optimize_s=out["time_s"], sgd_ms_per_step=ms, step=self.state.step,
                  losses=losses, window_games=len(tags), ranks_state_equal=True,
                  peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
                  host_rss_mib=zr.rss_mib())
        emit(dict(it))
        it.clear()
        return out

    pd.make_sharded_train_step = timed_step
    zl.ZeroLoop.__init__, zl.ZeroLoop.resume = wrapped_init, wrapped_resume
    zl.ZeroLoop.self_play_iteration = wrapped_self_play
    zl.ZeroLoop.optimize_iteration = wrapped_optimize
    zl.ZeroLoop._log_metrics = wrapped_log_metrics
    ReplayBuffer.add_game = tagged_add
    argv = ["-mode", "zero", "-multi_device", "-conf_file", a["conf"], "-conf_str",
            f"zero_end_iteration={a['end']}", "-run_dir", run_dir]
    if cli(argv) != 0:
        raise Failure(f"rank {rank}: the CLI returned non-zero")
    (loop,) = loops
    with open(os.path.join(run_dir, f"digest_rank{rank}_step{loop.state.step}.json"), "w") as f:
        json.dump({"games": [zr.game_digest(g) for g in loop.buffer.games],
                   "iterations": [g.iteration for g in loop.buffer.games],
                   "state": zr.state_digest(loop)}, f)
    if index == 2:
        # the gradient all-reduce of a step (one flat float32 tensor of
        # every parameter's gradient), alone
        n = sum(p.numel() for p in loop.network.parameters())
        flat = torch.zeros(n, device=loop.device)
        ms = time_collective(lambda: dist.all_reduce(flat))
        if rank == 0:
            emit({"part": "b", "allreduce_bytes_a_step": 4 * n, "allreduce_ms": ms,
                  "ranks": WORLD, "card": torch.cuda.get_device_name(loop.device)})
    emit({"done": "b", "rank": rank, "process": index})


def load_records(sgf_dir: str, iteration: int, env, device):
    """Every game of ``iteration``'s shards, with its feature planes
    replayed on ``device`` (``ZeroLoop``'s own replay)."""
    from minizero_tpu_torch.selfplay.record import game_record_from_string
    from minizero_tpu_torch.zero.loop import ZeroLoop

    names = sorted(f for f in os.listdir(sgf_dir)
                   if f.split(".")[0] == str(iteration) and f.endswith(".sgf"))
    recs = [game_record_from_string(ln, env.spec.action_size)[1]
            for name in names for ln in open(os.path.join(sgf_dir, name)) if ln.strip()]
    replayer = types.SimpleNamespace(env=env, device=device)
    for i in range(0, len(recs), 256):
        part = recs[i:i + 256]
        for rec, f in zip(part, ZeroLoop._rebuild_features_batch(replayer, [r.actions
                                                                            for r in part])):
            rec.features = f
    return recs


def step_parity(mesh, recipe: str, sgf_dir: str, iteration: int, path: str) -> None:
    """The sharded step on ``mesh``, from one set of weights, on one global
    batch of ``PARITY_BATCH`` rows of ``iteration``'s records with given
    rotations, float32 and TF32 off, for ``max(PARITY)`` steps; fails
    unless every rank's whole parameters are bitwise equal after each step
    of ``PARITY``. Rank 0 saves the weights, the batch, the rotations and
    those steps' parameters and metrics to ``path`` for ``plain_parity``,
    which runs the plain step outside the process group (in it, BatchNorm
    would reduce its statistics over the ranks). A collective: every rank
    calls it."""
    import torch
    import torch.distributed as dist

    from minizero_tpu_torch import upload
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.learner.replay import ReplayBuffer
    from minizero_tpu_torch.learner.train import init_train_state
    from minizero_tpu_torch.models.factory import create_network, init_network
    from minizero_tpu_torch.parallel.distributed import make_sharded_train_step
    from minizero_tpu_torch.parallel.mesh import batch_sharding, whole_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config(recipe)
    env = make_env(cfg)
    dev = mesh.device
    buffer = ReplayBuffer(cfg, env.spec)
    for rec in load_records(sgf_dir, iteration, env, dev):
        buffer.add_game(rec)
    rng = np.random.RandomState(PARITY_SEED)
    muzero = cfg.nn_type_name != "alphazero"
    batch = (buffer.sample_muzero if muzero else buffer.sample_alphazero)(PARITY_BATCH, rng)
    batch.pop("sampled_index")
    last = max(PARITY)
    rots = np.random.RandomState(PARITY_SEED + 1).randint(
        0, env.num_rotations(), (last, PARITY_BATCH)).astype(np.int64)
    net = init_network(create_network(cfg, env.spec), seed=PARITY_SEED).to(dev)
    initial = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    state = init_train_state(cfg, net)
    step = make_sharded_train_step(cfg, env, net, mesh)
    rows = batch_sharding(mesh, PARITY_BATCH)
    local = {k: upload(np.ascontiguousarray(v[rows]), dev) for k, v in batch.items()}
    snaps = {}
    for s in range(1, last + 1):
        m = step(state, local, rotations=torch.as_tensor(rots[s - 1][rows], device=dev))
        if s in PARITY:
            whole, _ = whole_state(mesh, net)
            h = hashlib.sha1()
            for k in sorted(whole):
                h.update(whole[k].detach().cpu().contiguous().view(-1).view(torch.uint8)
                         .numpy().tobytes())
            if len(set(gathered(h.hexdigest()))) != 1:
                raise Failure(f"{recipe} (dp {mesh.dp} x mp {mesh.mp}) step {s}: the ranks' "
                              "whole parameters differ")
            snaps[s] = ({k: v.detach().cpu().clone() for k, v in whole.items()},
                        {k: float(v) for k, v in m.items() if v.dim() == 0})
    if mesh.rank == 0:
        torch.save({"recipe": recipe, "dp": mesh.dp, "mp": mesh.mp, "batch": batch,
                    "rotations": rots, "initial": initial, "snaps": snaps}, path)
    dist.barrier()


def plain_parity(path: str) -> dict:
    """``step_parity``'s steps again with the plain step
    (``learner/train.make_train_step``) on card 0 in this process, from the
    same weights, batch and rotations: parameters and scalar metrics after
    each step of ``PARITY`` within its tolerance of the sharded step's
    (the largest differences and their names are kept, and printed where
    one is beyond).

    The plain steps also run on the batch's rows in ``REORDERINGS`` other
    orders, which change nothing but float32's summation order. After 1
    step the sharded step is held to 1e-5. After 10 steps on one batch this
    net's differences grow by 2-3x a step, most in the value head's 1 x 1
    convolution (its gradient goes through a BatchNorm of one channel) and
    in the value layer, and a reordered plain run moves about as far from
    the plain one as the sharded step does (on H100s, gaz: 8.5e-4 against
    the dp-4 step's 9.8e-4; gmz: 2.9e-3 against 2.0e-3): a 1e-4 limit
    would fail one card against itself. There the limit is 1e-4 or
    ``SPREAD_FACTOR`` times the largest reordered spread, whichever is
    wider; a fault of the sharded step (a wrong average or wrong batch
    statistics) shows at step 1, three orders of magnitude over 1e-5."""
    import torch

    from minizero_tpu_torch import upload
    from minizero_tpu_torch.envs import make_env
    from minizero_tpu_torch.learner.train import init_train_state, make_train_step
    from minizero_tpu_torch.models.factory import create_network

    job = torch.load(path, weights_only=False)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    recipe, what = job["recipe"], f"{job['recipe']} (dp {job['dp']} x mp {job['mp']})"
    cfg = config(recipe)
    env = make_env(cfg)
    net = create_network(cfg, env.spec)
    net.load_state_dict(job["initial"])
    net.to(dev)
    state = init_train_state(cfg, net)
    step = make_train_step(cfg, env, net)
    batch = {k: upload(np.ascontiguousarray(v), dev) for k, v in job["batch"].items()}
    names = [n for n, _ in net.named_parameters()]
    # the same plain steps on the rows in other orders: one card's own
    # spread, as far as float32 summation order goes
    reordered = []
    for i in range(REORDERINGS):
        perm = torch.as_tensor(np.random.RandomState(PARITY_SEED + 2 + i).permutation(
            PARITY_BATCH), device=dev)
        other = copy.deepcopy(net)
        reordered.append((perm, other, init_train_state(cfg, other),
                          make_train_step(cfg, env, other),
                          {k: v[perm] for k, v in batch.items()}))
    out = {"parity": recipe, "dp": job["dp"], "mp": job["mp"], "batch": PARITY_BATCH,
           "ranks_equal": True, "card": torch.cuda.get_device_name(dev)}
    failures = []

    def diffs(model, metrics, ref, ref_metrics):
        errs = {k: float((model[k] - ref[k]).abs().max()) for k in names}
        errs.update({k: abs(metrics[k] - float(ref_metrics[k])) for k in metrics})
        return errs

    for s in range(1, max(PARITY) + 1):
        rots = torch.as_tensor(job["rotations"][s - 1], device=dev)
        pm = step(state, batch, rotations=rots)
        oms = [ostep(ostate, obatch, rotations=rots[perm])
               for perm, _, ostate, ostep, obatch in reordered]
        if s not in PARITY:
            continue
        model, metrics = job["snaps"][s]
        want = {k: v.detach().cpu() for k, v in net.state_dict().items()}
        errs = diffs(model, metrics, want, pm)
        floor = max(max(diffs({k: v.detach().cpu() for k, v in other.state_dict().items()},
                              {k: float(om[k]) for k in metrics}, want, pm).values())
                    for (_, other, _, _, _), om in zip(reordered, oms))
        stats = [float((model[k] - want[k]).abs().max()) for k in want
                 if k.endswith(("running_mean", "running_var"))]
        # a step's limit: PARITY's, or SPREAD_FACTOR times one card's own
        # spread where that is wider (10 steps on one batch of this net: see
        # the docstring)
        limit = PARITY[s] if s == min(PARITY) else max(PARITY[s], SPREAD_FACTOR * floor)
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
        out[f"step{s}"] = {"tolerance": PARITY[s], "limit": limit, "max_err": worst[0][1],
                           "worst": worst, "one_card_reordered_err": floor,
                           "metrics": metrics,
                           "max_running_stat_err": max(stats) if stats else None}
        bad = [(k, v) for k, v in worst if v > limit]
        if bad:
            failures.append(f"{what} step {s}: beyond {limit:.3g} (one card reordered "
                            f"{floor:.3g}): " + ", ".join(f"{k} {v:.3g}" for k, v in bad))
    emit(out)
    if failures:
        raise Failure("; ".join(failures))
    return out


def rank_c(a: dict) -> None:
    import torch.distributed as dist

    from minizero_tpu_torch.parallel.mesh import make_mesh

    join()
    mesh = make_mesh()
    check_rank(mesh.device)
    for recipe in ("gaz", "gmz"):
        step_parity(mesh, recipe, a["sgf"], a["iteration"],
                    os.path.join(a["out"], f"parity_{recipe}_dp4.pt"))
    emit({"done": "c", "rank": dist.get_rank()})


def rank_d(a: dict) -> None:
    """One rank of (d): the dp 2 x mp 2 loop, its resume, its checkpoint,
    the split step against one card, the heads' gathers."""
    import torch
    import torch.distributed as dist

    from minizero_tpu_torch.learner.replay import ReplayBuffer
    from minizero_tpu_torch.parallel.mesh import make_mesh, whole_state
    from minizero_tpu_torch.zero.loop import ZeroLoop

    join()
    mesh = make_mesh(model_parallel=2)
    rank = check_rank(mesh.device)
    if (mesh.dp_rank, mesh.mp_rank, mesh.dp, mesh.mp) != (rank // 2, rank % 2, 2, 2):
        raise Failure(f"rank {rank}: coordinates {(mesh.dp_rank, mesh.mp_rank, mesh.dp, mesh.mp)}")
    run_dir = a["run_dir"]
    played = []
    add_game, self_play = ReplayBuffer.add_game, ZeroLoop.self_play_iteration

    def recording_add(self, record):
        played.append(record)
        add_game(self, record)

    def checked_self_play(self, iteration):
        played.clear()
        before = kernel_counts()
        stats = self_play(self, iteration)
        torch.cuda.synchronize()
        timing = self.last_selfplay_timing
        moves = timing["chunks"] * timing["moves_per_chunk"]
        launches = check_launches(before, moves, self.engine.spec.num_simulations,
                                  f"rank {rank} iteration {iteration}")
        digests = mp_games_agree(self.mesh, played)
        if len(set(digests)) != 1:
            raise Failure(f"rank {rank} iteration {iteration}: the mp group's games differ "
                          f"{digests}")
        emit({"part": "d", "rank": rank, "iteration": iteration, "games": len(played),
              "mp_group_games_equal": True, "digest": digests[0], "moves": moves,
              "launches": launches, "selfplay_s": stats["time_s"]})
        return stats

    ReplayBuffer.add_game = recording_add
    ZeroLoop.self_play_iteration = checked_self_play
    cfg = config().replace(zero_end_iteration=2)
    loop = ZeroLoop(cfg, run_dir, mesh=mesh)
    shapes = {k: tuple(v.shape) for k, v in loop.network.state_dict().items()}
    heads = {"policy_head.fc.weight": (41, 2 * 81), "value_head.fc1.weight": (128, 81),
             "value_head.fc2.weight": (1, 256)}
    if {k: shapes[k] for k in heads} != heads:
        raise Failure(f"rank {rank}: local heads {({k: shapes[k] for k in heads})}")
    loop.run()
    loop.close()
    del loop
    t = time.perf_counter()
    again = ZeroLoop(cfg.replace(zero_end_iteration=3), run_dir, mesh=mesh)
    start = again.resume()
    resume_s = time.perf_counter() - t
    if start != 2 or len(again.buffer) != GAMES:
        raise Failure(f"rank {rank}: resumed at {start} with {len(again.buffer)} games")
    again.run()
    again.close()
    whole, _ = whole_state(mesh, again.network)
    ckpt = os.path.join(run_dir, "model", f"weight_iter_{3 * cfg.learner_training_step}.ckpt")
    if rank == 0:
        payload = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
        if tuple(payload["policy_head.fc.weight"].shape) != (82, 2 * 81):
            raise Failure("the checkpoint's policy layer is not whole")
        plain_dir = os.path.join(os.path.dirname(run_dir), "d_plain")
        plain = ZeroLoop(cfg, plain_dir, device=mesh.device)
        plain.load_checkpoint(ckpt)
        plain.close()
        for k, v in plain.network.state_dict().items():
            if not torch.equal(v, whole[k]):
                raise Failure(f"the checkpoint loaded into a plain loop differs at {k}")
        del plain
    dist.barrier()
    for recipe in ("gaz", "gmz"):
        step_parity(mesh, recipe, os.path.join(run_dir, "sgf"), 3,
                    os.path.join(os.path.dirname(run_dir), f"parity_{recipe}_dp2_mp2.pt"))
    b_local = PARITY_BATCH // mesh.dp
    gathers = {}
    for name, cols in HEAD_GATHERS.items():
        buf = torch.zeros(b_local, cols, device=mesh.device)
        gathers[name] = {"shape": [b_local, cols],
                         "ms": time_collective(lambda: dist.all_reduce(buf, group=mesh.mp_group))}
    emit({"part": "d", "rank": rank, "resume_s": resume_s, "head_gathers": gathers,
          "checkpoint_loads_whole": rank == 0,
          "card": torch.cuda.get_device_name(mesh.device)})
    emit({"done": "d", "rank": rank})


def rank_e(a: dict) -> None:
    """One rank of (e): the CLI with the first statistics gather
    delayed 120 s on rank 3 (after a barrier that lines the ranks up)."""
    import torch
    import torch.distributed as dist

    from minizero_tpu_torch.__main__ import main as cli
    from minizero_tpu_torch.zero import loop as zl

    gather = zl.ZeroLoop._gathered_selfplay_stats

    def wedged(self, *args):
        dist.barrier()
        torch.cuda.synchronize()
        rank = dist.get_rank()
        emit({"part": "e", "rank": rank, "gather_entry": time.time()})
        if rank == WORLD - 1:
            print("RANK_3_WEDGED", flush=True)
            time.sleep(WEDGE_S)
        return gather(self, *args)

    zl.ZeroLoop._gathered_selfplay_stats = wedged
    join()
    cli(["-mode", "zero", "-multi_device", "-conf_file", a["conf"], "-conf_str", WEDGE_CONF,
         "-run_dir", a["run_dir"]])
    print("RANK_DONE", flush=True)


RANKS = {"b": rank_b, "c": rank_c, "d": rank_d, "e": rank_e}

if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        try:
            RANKS[sys.argv[2]](json.loads(sys.argv[3]))
        except Failure as e:
            print(f"multi_card_torch ({sys.argv[2]}) rank {os.environ.get('RANK')}: FAILED: {e}",
                  file=sys.stderr, flush=True)
            sys.exit(1)
    elif len(sys.argv) in (2, 3):
        sys.exit(main(*sys.argv[1:]))
    else:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        sys.exit(2)
