"""The port's tensor-parallel dense heads (``parallel/mesh.py``'s ``(dp,
mp)`` mesh, ``models/blocks.ColumnParallelLinear``) on the CPU: ranks are
processes joined over gloo on a local TCP rendezvous, each with one torch
thread (``test_torch_distributed.py``'s ``_gloo_jobs``).

- the AlphaZero and MuZero (K=2) train steps at dp 1 x mp 2 (2 ranks) and
  dp 2 x mp 2 (4 ranks) equal one process on the whole batch and the JAX
  package's ``make_sharded_train_step`` on a CPU mesh of the same shape
  (``make_mesh(n, model_parallel=2)``), from the same carried weights:
  parameters, running statistics, momentum and metrics within 1e-5; every
  rank ends with bitwise the same whole weights;
- the layout: each split head holds ``[out // 2, in]`` (Go's policy 82 ->
  41, the value hidden layer 16 -> 8), the scalar value layer stays whole,
  replicated tensors are bitwise equal on every rank;
- ``make_mesh(model_parallel=3)`` on 2 or 4 ranks raises ``ValueError``;
- a dp 1 x mp 2 ``ZeroLoop`` iteration on TicTacToe (its value hidden
  layer split 8 -> 4) writes the plain loop's files, records byte for
  byte; its checkpoint is the one-process format (it loads into a plain
  ``ZeroLoop`` and ``eval.match.load_checkpoint_variables``, and equals the
  plain loop's within 1e-5), and ``resume`` under mp = 2 splits it again;
- the check of ``scripts/multi_card_torch.py`` part (d) at dp 2 x mp 2 on
  four ranks: after each iteration a digest of each rank's games,
  all-gathered over its ``mp`` group, is equal within the group, differs
  between the ``dp`` rows, and differs within a group whose rank 1 lost a
  game.
"""

import copy
import os
import sys

import jax
import numpy as np
import pytest
import torch

from minizero_tpu.parallel.distributed import global_batch_from_local as jglobal_batch
from minizero_tpu.parallel.distributed import make_sharded_train_step as jmake_sharded_train_step
from minizero_tpu.parallel.mesh import make_mesh as jmake_mesh
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.eval.match import load_checkpoint_variables
from minizero_tpu_torch.zero.loop import ZeroLoop

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import _gloo_jobs  # noqa: E402
from test_torch_train import CASES, _Pair  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ATOL = 1e-5
MP = 2
SHAPES = {"dp1_mp2": 2, "dp2_mp2": 4}  # name: ranks
TRAIN_CASES = ("go_az_sgd", "go_muzero_k2_sgd")

# one rank of a (dp, mp) gloo job: argv as test_torch_distributed._WORKER's
_TRAIN_WORKER = r"""
import pickle, sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[6])
torch.set_num_threads(1)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.envs import make_env
from minizero_tpu_torch.learner.train import init_train_state
from minizero_tpu_torch.models.factory import create_network
from minizero_tpu_torch.parallel.distributed import make_sharded_train_step
from minizero_tpu_torch.parallel.mesh import batch_sharding, local_state, make_mesh, whole_state

try:
    make_mesh(world, model_parallel=3, device="cpu")
    bad_mesh = None
except ValueError as e:
    bad_mesh = str(e)
mesh = make_mesh(world, model_parallel=2, device="cpu")
out = {"bad_mesh": bad_mesh, "coords": (mesh.dp_rank, mesh.mp_rank, mesh.dp, mesh.mp),
       "steps": []}
for job in pickle.load(open(sys.argv[4], "rb")):
    cfg = default_config(job["env"], **job["over"])
    env = make_env(cfg)
    net = create_network(cfg, env.spec)
    state = init_train_state(cfg, net)
    step = make_sharded_train_step(cfg, env, net, mesh)  # splits the heads
    model, opt = local_state(mesh, net, job["model"], job["optimizer"])
    net.load_state_dict(model)
    state.optimizer.load_state_dict(opt)
    state.step = job["step"]
    rows = batch_sharding(mesh, len(job["rotations"]))
    metrics = step(state, {k: v[rows] for k, v in job["batch"].items()},
                   rotations=torch.as_tensor(job["rotations"][rows]))
    whole, whole_opt = whole_state(mesh, net, state.optimizer)
    out["steps"].append({"model": whole, "optimizer": whole_opt, "metrics": metrics,
                         "local": {k: v.clone() for k, v in net.state_dict().items()}})
torch.save(out, sys.argv[5])
dist.destroy_process_group()
print(f"RANK_{rank}_DONE", flush=True)
"""

# one rank of a dp 1 x mp 2 zero loop: one iteration, then resume and a second
_LOOP_WORKER = r"""
import pickle, sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[6])
torch.set_num_threads(1)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.parallel.mesh import make_mesh, whole_state
from minizero_tpu_torch.zero.loop import ZeroLoop

job = pickle.load(open(sys.argv[4], "rb"))
mesh = make_mesh(model_parallel=2, device="cpu")
loop = ZeroLoop(default_config("tictactoe", **job["over"]), job["run_dir"], mesh=mesh)
loop.run()
loop.close()
out = {"whole": whole_state(mesh, loop.network)[0], "play": loop.play_network.state_dict(),
       "local_shapes": {k: tuple(v.shape) for k, v in loop.network.state_dict().items()}}
again = ZeroLoop(default_config("tictactoe", **dict(job["over"], zero_end_iteration=2)),
                 job["run_dir"], mesh=mesh)
out["resumed_at"] = again.resume()
out["resumed_local"] = {k: v.clone() for k, v in again.network.state_dict().items()}
again.run()
again.close()
out["end_whole"] = whole_state(mesh, again.network)[0]
out["end_play"] = again.play_network.state_dict()
torch.save(out, sys.argv[5])
dist.destroy_process_group()
print(f"RANK_{rank}_DONE", flush=True)
"""


def _close(got, want, what, counts=True):
    """Every tensor of ``want`` within ATOL in ``got``; BatchNorm's step
    counts (which flax does not keep) equal where ``counts``."""
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            assert not counts or int(got[name]) == int(w), f"{what}: {name}"
            continue
        err = float((got[name] - w).abs().max())
        assert err <= ATOL, f"{what}: {name} differs by {err}"


def _equal(a, b, what):
    assert sorted(a) == sorted(b), what
    for name in a:
        assert torch.equal(a[name], b[name]), f"{what}: {name}"


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """For each mesh shape: the JAX sharded step's and the port's plain
    step's results from the same carried state, and every rank's results
    of the split step (``_TRAIN_WORKER``)."""
    runs = {}
    for shape, world in SHAPES.items():
        jmesh = jmake_mesh(world, model_parallel=MP)
        cases, jobs = [], []
        rng = np.random.default_rng(3)
        for name in TRAIN_CASES:
            env_name, over, b, value_size = CASES[name]
            pair = _Pair(env_name, over, value_size=value_size, seed=4)
            pair.sync()
            tbatch, jbatch = pair.batch(rng, b, pair.tcfg.learner_muzero_unrolling_step)
            key = jax.random.PRNGKey(7)
            rots = np.asarray(jax.random.randint(key, (b,), 0, pair.jenv.num_rotations()))
            jobs.append({"env": env_name, "over": over,
                         "model": {k: v.clone() for k, v in pair.tnet.state_dict().items()},
                         "optimizer": copy.deepcopy(pair.tstate.optimizer.state_dict()),
                         "step": pair.tstate.step, "batch": tbatch, "rotations": rots})
            # the JAX package's sharded step on a (dp, 2) mesh: heads over mp
            step, placed, _ = jmake_sharded_train_step(pair.jcfg, pair.jenv, pair.jnet, jmesh,
                                                       pair.jstate)
            jstate, jm = step(placed, jglobal_batch(jmesh, jbatch), key)
            tm = pair.tstep(pair.tstate, tbatch, rotations=torch.from_numpy(rots.copy()))
            params = dict(pair.tnet.named_parameters())
            momentum = {n: pair.tstate.optimizer.state[p]["momentum_buffer"].clone()
                        for n, p in params.items()}
            cases.append({"jmodel": pair._convert(jstate.params, jstate.batch_stats), "jm": jm,
                          "tmodel": {k: v.clone() for k, v in pair.tnet.state_dict().items()},
                          "tm": tm, "momentum": momentum, "names": list(params)})
        ranks = _gloo_jobs(tmp_path_factory.mktemp(shape), jobs, world, _TRAIN_WORKER)
        runs[shape] = (cases, ranks)
    return runs


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_split_train_step_equals_one_process_and_jax_sharded(train_runs, shape, case):
    cases, ranks = train_runs[shape]
    i = TRAIN_CASES.index(case)
    want = cases[i]
    got = ranks[0]["steps"][i]
    what = f"{case} {shape}"
    for r, rk in enumerate(ranks):
        _equal(rk["steps"][i]["model"], got["model"], f"{what}: rank {r}'s whole weights")
    _close(got["model"], want["tmodel"], f"{what} vs one process")
    _close(got["model"], want["jmodel"], f"{what} vs the JAX sharded step", counts=False)
    opt_state = got["optimizer"]["state"]
    for j, name in enumerate(want["names"]):
        err = float((opt_state[j]["momentum_buffer"] - want["momentum"][name]).abs().max())
        assert err <= ATOL, f"{what}: {name}'s momentum differs by {err}"
    assert sorted(got["metrics"]) == sorted(want["tm"]) == sorted(want["jm"]), what
    for k, v in want["tm"].items():
        np.testing.assert_allclose(got["metrics"][k].numpy(), v.numpy(), atol=ATOL,
                                   err_msg=f"{what}: {k} vs one process")
        np.testing.assert_allclose(got["metrics"][k].numpy(), np.asarray(want["jm"][k]),
                                   atol=ATOL, err_msg=f"{what}: {k} vs the JAX sharded step")
        for r, rk in enumerate(ranks):
            assert torch.equal(rk["steps"][i]["metrics"][k], got["metrics"][k]), f"{what}: {k}, {r}"


def _heads(case):
    """The split weights' names with their whole shapes, and the scalar
    value layer's weight name, of a case's net at SMALL widths (16 hidden
    channels) on Go 9x9."""
    pre = "prediction." if "muzero" in case else ""
    split = {f"{pre}policy_head.fc.weight": (82, 2 * 81), f"{pre}value_head.fc1.weight": (16, 81)}
    return split, f"{pre}value_head.fc2.weight"


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_split_layout(train_runs, shape):
    cases, ranks = train_runs[shape]
    world = SHAPES[shape]
    assert [rk["coords"] for rk in ranks] == [(r // MP, r % MP, world // MP, MP)
                                               for r in range(world)]
    for i, case in enumerate(TRAIN_CASES):
        split, scalar = _heads(case)
        whole = ranks[0]["steps"][i]["model"]
        for r, rk in enumerate(ranks):
            local = rk["steps"][i]["local"]
            for name, (out, inp) in split.items():
                assert tuple(local[name].shape) == (out // MP, inp), (case, r, name)
                rows = slice((r % MP) * out // MP, (r % MP + 1) * out // MP)
                assert torch.equal(local[name], whole[name][rows]), (case, r, name)
                bias = name[:-len("weight")] + "bias"
                assert torch.equal(local[bias], whole[bias][rows]), (case, r, bias)
            assert tuple(local[scalar].shape) == (1, 16), (case, r)
            # every replicated tensor is bitwise rank 0's
            for name, t in local.items():
                if name not in split and name[:-len("bias")] + "weight" not in split:
                    assert torch.equal(t, ranks[0]["steps"][i]["local"][name]), (case, r, name)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_make_mesh_refuses_an_mp_that_does_not_divide_the_ranks(train_runs, shape):
    _, ranks = train_runs[shape]
    for rk in ranks:
        assert rk["bad_mesh"] is not None and "model_parallel=3" in rk["bad_mesh"], rk["bad_mesh"]


LOOP_OVER = dict(nn_num_blocks=1, nn_num_hidden_channels=8, nn_num_value_hidden_channels=8,
                 actor_num_simulation=8, learner_batch_size=16, learner_training_step=4,
                 learner_training_display_step=2, zero_num_games_per_iteration=8,
                 zero_num_parallel_games=8, zero_end_iteration=1)


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """A plain one-iteration TicTacToe loop, and the same at dp 1 x mp 2
    (then resumed for a second iteration) on two gloo ranks. Both run
    directories have the same name, which the analysis plots carry."""
    root = tmp_path_factory.mktemp("loops")
    plain_dir = str(root / "plain" / "run")
    plain = ZeroLoop(default_config("tictactoe", **LOOP_OVER), plain_dir, device="cpu")
    plain.run()
    plain.close()
    files = sorted(os.path.relpath(os.path.join(d, f), plain_dir)
                   for d, _, fs in os.walk(plain_dir) for f in fs)
    split_dir = str(root / "split" / "run")
    ranks = _gloo_jobs(root, {"over": LOOP_OVER, "run_dir": split_dir}, 2, _LOOP_WORKER)
    return {"plain": plain, "plain_dir": plain_dir, "files": files,
            "split_dir": split_dir,
            "ranks": ranks}


def test_mp2_zero_loop_writes_the_plain_loops_records(loop_runs):
    split_dir = loop_runs["split_dir"]
    want = open(os.path.join(loop_runs["plain_dir"], "sgf", "1.sgf")).read()
    assert want and open(os.path.join(split_dir, "sgf", "1.sgf")).read() == want
    # the mp rank 1 wrote no file of its own: the run's files are the plain
    # loop's, and the resumed second iteration's
    files = sorted(os.path.relpath(os.path.join(d, f), split_dir)
                   for d, _, fs in os.walk(split_dir) for f in fs)
    assert files == sorted(loop_runs["files"] + [os.path.join("sgf", "2.sgf"),
                                                 os.path.join("model", "weight_iter_8.ckpt")])
    log = open(os.path.join(split_dir, "Training.log")).read()
    assert "[Iteration] 1: self-play 8 games" in log and " 1 hosts)" in log
    r0, r1 = loop_runs["ranks"]
    # the value head's hidden layer (8) splits, the policy layer (9) does not
    assert r0["local_shapes"]["value_head.fc1.weight"] == (4, 9)
    assert r0["local_shapes"]["policy_head.fc.weight"] == (9, 9)
    for key in ("whole", "play", "end_whole", "end_play"):
        _equal(r0[key], r1[key], f"{key} on the two ranks")
    _equal(r0["whole"], r0["play"], "the trained heads and self-play's network")
    _equal(r0["end_whole"], r0["end_play"], "after the resumed iteration")


def test_mp2_checkpoint_loads_into_a_plain_loop_and_eval(loop_runs, tmp_path):
    split_dir, plain = loop_runs["split_dir"], loop_runs["plain"]
    ckpt = os.path.join(split_dir, "model", "weight_iter_4.ckpt")
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    cfg = default_config("tictactoe", **LOOP_OVER)
    loop = ZeroLoop(cfg, str(tmp_path / "reader"), device="cpu")
    loop.load_checkpoint(ckpt)
    loop.close()
    _equal(loop.network.state_dict(), loop_runs["ranks"][0]["whole"], "a plain loop's load")
    _equal(load_checkpoint_variables(ckpt, cfg).state_dict(), payload["model"], "eval's load")
    want = torch.load(os.path.join(loop_runs["plain_dir"], "model", "weight_iter_4.ckpt"),
                      map_location="cpu", weights_only=True)
    _close(payload["model"], want["model"], "the mp 2 checkpoint vs the plain loop's")
    got_opt, want_opt = payload["optimizer"], want["optimizer"]
    assert sorted(got_opt["state"]) == sorted(want_opt["state"])
    for i, bufs in want_opt["state"].items():
        err = float((got_opt["state"][i]["momentum_buffer"] - bufs["momentum_buffer"]).abs().max())
        assert err <= ATOL, f"parameter {i}'s momentum differs by {err}"
    assert plain.state.step == payload["training_step"] == 4


def test_mp2_resume_splits_the_checkpoint_again(loop_runs):
    split_dir = loop_runs["split_dir"]
    log = open(os.path.join(split_dir, "Training.log")).read()
    assert "[Resume] iteration 1, 8 games reloaded" in log
    payload = torch.load(os.path.join(split_dir, "model", "weight_iter_4.ckpt"),
                         map_location="cpu", weights_only=True)["model"]
    for r, rk in enumerate(loop_runs["ranks"]):
        assert rk["resumed_at"] == 1
        local = rk["resumed_local"]
        rows = slice(4 * r, 4 * (r + 1))
        for name in ("value_head.fc1.weight", "value_head.fc1.bias"):
            assert torch.equal(local[name], payload[name][rows]), (r, name)
        for name, t in local.items():
            if not name.startswith("value_head.fc1."):
                assert torch.equal(t, payload[name]), (r, name)


# one rank of a dp 2 x mp 2 TicTacToe loop, two iterations, each followed by
# scripts/multi_card_torch.py's mp-group check of the games just played
_MP_GAMES_WORKER = r"""
import importlib.util, os, pickle, sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[6])
torch.set_num_threads(1)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
spec = importlib.util.spec_from_file_location(
    "multi_card_torch", os.path.join(sys.argv[6], "scripts", "multi_card_torch.py"))
mc = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mc)
from minizero_tpu_torch.config import default_config
from minizero_tpu_torch.learner.replay import ReplayBuffer
from minizero_tpu_torch.parallel.mesh import make_mesh
from minizero_tpu_torch.zero.loop import ZeroLoop

job = pickle.load(open(sys.argv[4], "rb"))
mesh = make_mesh(model_parallel=2, device="cpu")
played, out = [], {"digests": [], "games": []}
add_game, self_play = ReplayBuffer.add_game, ZeroLoop.self_play_iteration

def recording_add(self, record):
    played.append(record)
    add_game(self, record)

def checked(self, iteration):
    played.clear()
    stats = self_play(self, iteration)
    out["digests"].append(mc.mp_games_agree(self.mesh, played))
    out["games"].append(len(played))
    return stats

ReplayBuffer.add_game, ZeroLoop.self_play_iteration = recording_add, checked
loop = ZeroLoop(default_config("tictactoe", **job["over"]), job["run_dir"], mesh=mesh)
loop.run()
loop.close()
# a group whose rank 1 lost a game
out["split"] = mc.mp_games_agree(mesh, played[:-1] if mesh.mp_rank == 1 else played)
out["coords"] = (mesh.dp_rank, mesh.mp_rank)
torch.save(out, sys.argv[5])
dist.destroy_process_group()
print(f"RANK_{rank}_DONE", flush=True)
"""


def test_dp2_mp2_groups_play_the_same_games(tmp_path):
    over = dict(LOOP_OVER, zero_end_iteration=2)
    ranks = _gloo_jobs(tmp_path, {"over": over, "run_dir": str(tmp_path / "run")}, 4,
                       _MP_GAMES_WORKER)
    assert [rk["coords"] for rk in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r, rk in enumerate(ranks):
        assert rk["games"] == [4, 4], r  # ceil(8 / dp) games a row an iteration
        assert len(rk["digests"]) == 2
        for digests in rk["digests"]:
            assert len(digests) == 2 and digests[0] == digests[1], (r, digests)
        assert rk["digests"] == ranks[2 * (r // 2)]["digests"], r
        assert rk["split"][0] != rk["split"][1], r
    for i in range(2):  # the dp rows play different games
        assert ranks[0]["digests"][i][0] != ranks[2]["digests"][i][0], i
