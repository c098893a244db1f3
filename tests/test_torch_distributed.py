"""The port's data-parallel path (``minizero_tpu_torch/parallel/``) on the
CPU: ranks are processes joined over gloo on a local TCP rendezvous, each
with one torch thread.

- the 2-rank AlphaZero and MuZero train steps (gradient averaged, BatchNorm
  statistics over the global batch) equal a 1-process step on the
  concatenated batch, and the JAX package's ``make_sharded_train_step`` on
  a 2-device CPU mesh from the same carried weights: parameters, running
  statistics and metrics within 1e-5 (the frameworks and the split sums
  round differently by a few ulps); both ranks hold bitwise the same
  parameters after the step;
- 2-rank self-play with noise, rotation and sampling off plays the same
  actions as the plain engine on the same game slices;
- a 2-rank ``ZeroLoop`` iteration through ``-mode zero -multi_device``
  (``spawn_ranks``): record shards, a checkpoint from rank 0 alone, the
  ``(2 hosts)`` line, and ``resume`` of each rank's shard;
- a world-1 gloo loop writes the plain loop's records, byte for byte;
- a wedged peer makes rank 0 exit with the watchdog's code within 60 s
  (JAX ``tests/test_multihost.py:136-168``).
"""

import copy
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from minizero_tpu.parallel.distributed import global_batch_from_local as jglobal_batch
from minizero_tpu.parallel.distributed import make_sharded_train_step as jmake_sharded_train_step
from minizero_tpu.parallel.mesh import make_mesh as jmake_mesh
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.models.factory import create_network, init_network
from minizero_tpu_torch.parallel.distributed import init_distributed
from minizero_tpu_torch.parallel.mesh import batch_sharding, make_mesh
from minizero_tpu_torch.parallel.watchdog import WATCHDOG_EXIT_CODE
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine
from minizero_tpu_torch.zero.loop import ZeroLoop

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train import CASES, _Pair  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
TIMEOUT = 120

TINY = dict(nn_num_blocks=1, nn_num_hidden_channels=8, nn_num_value_hidden_channels=8,
            actor_num_simulation=8)
# deterministic self-play: plain AlphaZero, no root noise, no rotation,
# the most visited action
FIXED_PLAY = dict(TINY, actor_use_dirichlet_noise=False, actor_use_random_rotation_features=False,
                  actor_select_action_by_count=True, actor_select_action_by_softmax_count=False)

# one rank of a gloo job: argv = rank, world, port, job file, output file
_WORKER = r"""
import pickle, sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[6])
torch.set_num_threads(1)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.learner.train import init_train_state
from minizero_tpu_torch.models.factory import create_network, init_network
from minizero_tpu_torch.parallel.distributed import ShardedSelfPlay, make_sharded_train_step
from minizero_tpu_torch.parallel.mesh import batch_sharding, make_mesh
from minizero_tpu_torch.selfplay.engine import SelfPlayEngine

mesh = make_mesh(world, device="cpu")
out = []
for job in pickle.load(open(sys.argv[4], "rb")):
    cfg = default_config(job["env"], **job["over"])
    env = make_env(cfg)
    if job["kind"] == "train":
        net = create_network(cfg, env.spec)
        net.load_state_dict(job["model"])
        state = init_train_state(cfg, net)
        state.optimizer.load_state_dict(job["optimizer"])
        state.step = job["step"]
        rows = batch_sharding(mesh, len(job["rotations"]))
        step = make_sharded_train_step(cfg, env, net, mesh)
        metrics = step(state, {k: v[rows] for k, v in job["batch"].items()},
                       rotations=torch.as_tensor(job["rotations"][rows]))
        out.append({"model": net.state_dict(), "metrics": metrics,
                    "flat": torch.cat([p.detach().reshape(-1) for p in net.parameters()])})
    else:
        net = init_network(create_network(cfg, env.spec), seed=0)
        sp = ShardedSelfPlay(SelfPlayEngine(env, cfg, net, use_bf16=False, device="cpu"), mesh)
        states = sp.init_batch(job["games"])
        actions = []
        for _ in range(job["moves"]):
            o = sp.move(states)
            actions.append(o.action.numpy())
            states = o.states
        out.append({"actions": np.stack(actions)})
torch.save(out, sys.argv[5])
dist.destroy_process_group()
print(f"RANK_{rank}_DONE", flush=True)
"""

# a rank that wedges after building its loop: argv = rank, world, port, run dir
_WEDGED = r"""
import os, sys, time
import torch
sys.path.insert(0, sys.argv[5])
torch.set_num_threads(1)
rank, world, port, run_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                  MASTER_ADDR="localhost", MASTER_PORT=port)
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.parallel.distributed import init_distributed
from minizero_tpu_torch.parallel.mesh import make_mesh
from minizero_tpu_torch.zero.loop import ZeroLoop
init_distributed(device="cpu")
cfg = default_config("tictactoe", nn_num_blocks=1, nn_num_hidden_channels=8,
                     nn_num_value_hidden_channels=8, actor_num_simulation=4,
                     zero_num_parallel_games=8, zero_num_games_per_iteration=4,
                     learner_training_step=2, learner_batch_size=8, zero_end_iteration=1,
                     zero_collective_timeout=5.0)
loop = ZeroLoop(cfg, run_dir, mesh=make_mesh(device="cpu"))
if rank == 1:
    # alive, but out of every collective from here on
    print("RANK_1_WEDGED", flush=True)
    time.sleep(3600)
loop.run()
print("RANK_0_DONE", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _one_thread_env():
    env = dict(os.environ)
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    return env


def _run_ranks(code, args_of_rank, world=2, timeout=TIMEOUT):
    """Start ``world`` processes of ``code``; returns their (returncode,
    output) pairs. Each process has its own time limit."""
    procs = [subprocess.Popen([sys.executable, "-c", code, *args_of_rank(r)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=_one_thread_env())
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=timeout)[0], p.returncode))
    finally:
        for p in procs:
            p.kill()
    return [(rc, out) for out, rc in outs]


def _gloo_jobs(tmp_path, jobs, world=2, worker=_WORKER):
    """Run ``jobs`` on ``world`` gloo ranks of ``worker`` (argv as
    ``_WORKER``'s); returns each rank's results."""
    job_file = str(tmp_path / "jobs.pkl")
    with open(job_file, "wb") as f:
        pickle.dump(jobs, f)
    port = str(_free_port())
    res = _run_ranks(worker, lambda r: [str(r), str(world), port, job_file,
                                        str(tmp_path / f"out{r}.pt"), ROOT], world)
    for r, (rc, out) in enumerate(res):
        assert rc == 0 and f"RANK_{r}_DONE" in out, f"rank {r}:\n{out[-4000:]}"
    return [torch.load(str(tmp_path / f"out{r}.pt"), weights_only=False) for r in range(world)]


def test_init_distributed_without_a_launcher_is_a_no_op(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() == (0, 1)
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.device.type) == (0, 1, "cpu")
    assert batch_sharding(mesh, 8) == slice(0, 8)
    # one rank cannot hold mp = 2
    with pytest.raises(ValueError, match="model_parallel=2"):
        make_mesh(model_parallel=2, device="cpu")


def _compare_models(got, want, what, counts=True):
    """Parameters and running statistics within ATOL; BatchNorm's step
    counts (which flax does not keep) equal where ``counts``."""
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            assert not counts or int(got[name]) == int(w), f"{what}: {name}"
            continue
        err = float((got[name] - w).abs().max())
        assert err <= ATOL, f"{what}: {name} differs by {err}"


def test_two_rank_train_steps_equal_one_process_and_jax_sharded(tmp_path):
    """The AlphaZero and MuZero (K=2) steps, SGD with momentum, on an
    8-row batch split 4 + 4."""
    jmesh = jmake_mesh(2)
    cases, jobs = [], []
    rng = np.random.default_rng(3)
    for name in ("go_az_sgd", "go_muzero_k2_sgd"):
        env_name, over, b, value_size = CASES[name]
        pair = _Pair(env_name, over, value_size=value_size, seed=4)
        pair.sync()
        tbatch, jbatch = pair.batch(rng, b, pair.tcfg.learner_muzero_unrolling_step)
        key = jax.random.PRNGKey(7)
        rots = np.asarray(jax.random.randint(key, (b,), 0, pair.jenv.num_rotations()))
        jobs.append({"kind": "train", "env": env_name, "over": over,
                     "model": {k: v.clone() for k, v in pair.tnet.state_dict().items()},
                     "optimizer": copy.deepcopy(pair.tstate.optimizer.state_dict()),
                     "step": pair.tstate.step,
                     "batch": tbatch, "rotations": rots})
        # the JAX package's sharded step from the same state, batch over dp
        step, placed, _ = jmake_sharded_train_step(pair.jcfg, pair.jenv, pair.jnet, jmesh,
                                                   pair.jstate)
        jstate, jm = step(placed, jglobal_batch(jmesh, jbatch), key)
        # the port's plain step on the whole batch
        tm = pair.tstep(pair.tstate, tbatch, rotations=torch.from_numpy(rots.copy()))
        cases.append((name, pair._convert(jstate.params, jstate.batch_stats), jm,
                      {k: v.clone() for k, v in pair.tnet.state_dict().items()}, tm))
    ranks = _gloo_jobs(tmp_path, jobs)
    for i, (name, jmodel, jm, tmodel, tm) in enumerate(cases):
        r0, r1 = ranks[0][i], ranks[1][i]
        assert torch.equal(r0["flat"], r1["flat"]), f"{name}: the ranks' parameters differ"
        _compare_models(r0["model"], tmodel, f"{name} vs one process")
        _compare_models(r0["model"], jmodel, f"{name} vs the JAX sharded step", counts=False)
        assert sorted(r0["metrics"]) == sorted(tm) == sorted(jm), name
        for k in tm:
            np.testing.assert_allclose(r0["metrics"][k].numpy(), tm[k].numpy(), atol=ATOL,
                                       err_msg=f"{name}: {k} vs one process")
            np.testing.assert_allclose(r0["metrics"][k].numpy(), np.asarray(jm[k]), atol=ATOL,
                                       err_msg=f"{name}: {k} vs the JAX sharded step")
            assert torch.equal(r0["metrics"][k], r1["metrics"][k]), f"{name}: {k} per rank"


def test_two_rank_selfplay_equals_the_plain_engine_on_its_slices(tmp_path):
    games, moves = 16, 3
    cfg = default_config("tictactoe", **FIXED_PLAY)
    env = make_env(cfg)
    engine = SelfPlayEngine(env, cfg, init_network(create_network(cfg, env.spec), seed=0),
                            use_bf16=False, device="cpu")
    states = engine.init_batch(games)
    want = []
    for _ in range(moves):
        out = engine.move(states)
        want.append(out.action.numpy())
        states = out.states
    want = np.stack(want)
    ranks = _gloo_jobs(tmp_path, [{"kind": "selfplay", "env": "tictactoe", "over": FIXED_PLAY,
                                   "games": games, "moves": moves}])
    got = np.concatenate([r[0]["actions"] for r in ranks], axis=1)
    np.testing.assert_array_equal(got, want)


def _loop_conf(end_iteration: int) -> str:
    over = dict(TINY, learner_batch_size=16, learner_training_step=4,
                learner_training_display_step=2, zero_num_games_per_iteration=8,
                zero_num_parallel_games=8, zero_end_iteration=end_iteration)
    return "env_name=tictactoe:" + ":".join(f"{k}={v}" for k, v in over.items())


_SPAWN = r"""
import sys
sys.path.insert(0, sys.argv[1])
from minizero_tpu_torch.__main__ import spawn_ranks
if __name__ == "__main__":
    spawn_ranks(["-mode", "zero", "-multi_device", "-run_dir", sys.argv[2],
                 "-conf_str", sys.argv[3]], 2, device="cpu")
    print("SPAWN_DONE", flush=True)
"""


def test_two_rank_zero_loop_shards_checkpoint_and_resume(tmp_path):
    run_dir = str(tmp_path / "run")
    for end in (1, 2):
        (rc, out), = _run_ranks(_SPAWN, lambda r: [ROOT, run_dir, _loop_conf(end)], world=1)
        assert rc == 0 and "SPAWN_DONE" in out, out[-4000:]
    sgf = os.path.join(run_dir, "sgf")
    assert sorted(os.listdir(sgf)) == ["1.p1.sgf", "1.sgf", "2.p1.sgf", "2.sgf"]
    for name in os.listdir(sgf):  # ceil(8 / 2) games a rank an iteration
        assert len(open(os.path.join(sgf, name)).read().splitlines()) == 4, name
    assert sorted(os.listdir(os.path.join(run_dir, "model"))) == [
        "weight_iter_0.ckpt", "weight_iter_4.ckpt", "weight_iter_8.ckpt"]
    log0 = open(os.path.join(run_dir, "Training.log")).read()
    log1 = open(os.path.join(run_dir, "Training.p1.log")).read()
    for log in (log0, log1):
        assert "[Iteration] 1: self-play 8 games" in log and "2 hosts)" in log
        # the second run read back its own shard: 4 games
        assert "[Resume] iteration 1, 4 games reloaded" in log
    for name in ("op.log", "op.p1.log", "perf.jsonl", "perf.p1.jsonl"):
        assert os.path.getsize(os.path.join(run_dir, name)) > 0, name
    # the ranks applied the same updates: their op.log lines agree
    strip = lambda p: [x.split("] ", 1)[1] for x in open(os.path.join(run_dir, p))]  # noqa: E731
    assert strip("op.log") == strip("op.p1.log") and len(strip("op.log")) == 4


def test_world_one_gloo_loop_writes_the_plain_loops_records(tmp_path):
    cfg = default_config("tictactoe", **dict(
        TINY, learner_batch_size=16, learner_training_step=4, learner_training_display_step=2,
        zero_num_games_per_iteration=8, zero_num_parallel_games=8, zero_end_iteration=2))
    plain = ZeroLoop(cfg, str(tmp_path / "plain"), device="cpu")
    plain.run()
    plain.close()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        loop = ZeroLoop(cfg, str(tmp_path / "mesh"), mesh=make_mesh(device="cpu"))
        loop.run()
        loop.close()
    finally:
        dist.destroy_process_group()
    for it in (1, 2):
        a = open(tmp_path / "plain" / "sgf" / f"{it}.sgf").read()
        assert a and a == open(tmp_path / "mesh" / "sgf" / f"{it}.sgf").read(), it
    assert " 1 hosts)" in open(tmp_path / "mesh" / "Training.log").read()
    for name, p in plain.network.state_dict().items():
        assert torch.equal(p, loop.network.state_dict()[name]), name


def test_wedged_peer_aborts_rank_zero(tmp_path):
    port = str(_free_port())
    run_dir = str(tmp_path / "run")
    procs = [subprocess.Popen([sys.executable, "-c", _WEDGED, str(r), "2", port, run_dir, ROOT],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=_one_thread_env())
             for r in range(2)]
    try:
        out0, _ = procs[0].communicate(timeout=60)
    finally:
        procs[1].kill()
    out1, _ = procs[1].communicate(timeout=30)
    assert "RANK_1_WEDGED" in out1
    assert procs[0].returncode == WATCHDOG_EXIT_CODE, f"rank 0:\n{out0[-4000:]}"
    assert "[Watchdog] collective" in out0
    assert "RANK_0_DONE" not in out0
