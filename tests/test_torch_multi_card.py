"""The port's data-parallel path at four ranks, and how ranks find their
cards, on the CPU.

- the dp-4 train steps, Gumbel AlphaZero and Gumbel MuZero (K=2), on four
  gloo ranks (``test_torch_distributed.py``'s ``_gloo_jobs``), 2 rows a
  rank, equal one process on the 8-row global batch and the JAX package's
  ``make_sharded_train_step`` on a 4-device CPU mesh
  (``minizero_tpu.parallel.mesh.make_mesh(4)``) after 3 chained steps from
  the same carried weights: parameters, running statistics, momentum and
  metrics within 1e-5, the four ranks bitwise equal;
- the same two dp-4 steps and the plain step in float64 (the networks cast
  to float64), 10 chained steps from the same carried state on the same
  batches: within 1e-10 of each other, where the float32 steps of the same
  run move apart by order of summation alone (within 1e-5);
- with ``torch.cuda`` patched to four cards: ``local_device`` gives
  ``cuda:r`` for ``LOCAL_RANK=r``, ``init_distributed`` sets that card
  before it joins NCCL, ``-mode zero -multi_device`` without a launcher
  calls ``spawn_ranks(argv, 4)``, a spawned rank's environment names its
  rank, its card and the world, and under ``python -m minizero_tpu_torch``
  the spawned ranks' entry is a function they can import.
"""

import copy
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from minizero_tpu.parallel.distributed import global_batch_from_local as jglobal_batch
from minizero_tpu.parallel.distributed import make_sharded_train_step as jmake_sharded_train_step
from minizero_tpu.parallel.mesh import make_mesh as jmake_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import _gloo_jobs  # noqa: E402
from test_torch_train import CASES, SMALL, _Pair  # noqa: E402

from minizero_tpu_torch.learner.train import init_train_state, make_train_step  # noqa: E402
from minizero_tpu_torch.models.factory import create_network  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ATOL = 1e-5
WORLD = 4
STEPS = 3
STEP_CASES = {
    "gaz": CASES["go_gumbel_kl_sgd"],
    "gmz": ("go", dict(SMALL, nn_type_name="muzero", learner_muzero_unrolling_step=2,
                       actor_use_gumbel=True), 8, 0),
}

# one rank of a gloo job that chains a job's steps: argv as
# test_torch_distributed._WORKER's
_STEPS_WORKER = r"""
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
from minizero_tpu_torch.parallel.mesh import batch_sharding, make_mesh

mesh = make_mesh(world, device="cpu")
out = []
for job in pickle.load(open(sys.argv[4], "rb")):
    cfg = default_config(job["env"], **job["over"])
    env = make_env(cfg)
    net = create_network(cfg, env.spec)
    net.load_state_dict(job["model"])
    state = init_train_state(cfg, net)
    state.optimizer.load_state_dict(job["optimizer"])
    state.step = job["step"]
    step = make_sharded_train_step(cfg, env, net, mesh)
    metrics = []
    for batch, rots in zip(job["batches"], job["rotations"]):
        rows = batch_sharding(mesh, len(rots))
        metrics.append(step(state, {k: v[rows] for k, v in batch.items()},
                            rotations=torch.as_tensor(rots[rows])))
    params = dict(net.named_parameters())
    out.append({"model": net.state_dict(), "metrics": metrics,
                "momentum": {n: state.optimizer.state[p]["momentum_buffer"] for n, p in params.items()},
                "flat": torch.cat([p.detach().reshape(-1) for p in net.parameters()])})
torch.save(out, sys.argv[5])
dist.destroy_process_group()
print(f"RANK_{rank}_DONE", flush=True)
"""


# the float64 steps: the same worker with the network cast to float64
# before the carried state is loaded into it (the casts keep the values)
F64_STEPS = 10
F64_ATOL = 1e-10
_F64_STEPS_WORKER = _STEPS_WORKER.replace('net.load_state_dict(job["model"])',
                                          'net.to(job["dtype"]).load_state_dict(job["model"])')
assert _F64_STEPS_WORKER != _STEPS_WORKER


def _close(got, want, what, counts=True):
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            assert not counts or int(got[name]) == int(w), f"{what}: {name}"
            continue
        err = float((got[name] - w).abs().max())
        assert err <= ATOL, f"{what}: {name} differs by {err}"


@pytest.fixture(scope="module")
def dp4_steps(tmp_path_factory):
    """For each case: JAX's sharded steps on a 4-device mesh and the port's
    plain steps, 3 of each from the same carried state, and the four gloo
    ranks' dp-4 steps on the same batches and rotations."""
    jmesh = jmake_mesh(WORLD)
    cases, jobs = {}, []
    rng = np.random.default_rng(11)
    for name, (env_name, over, b, value_size) in STEP_CASES.items():
        pair = _Pair(env_name, over, value_size=value_size, seed=5)
        pair.sync()
        job = {"env": env_name, "over": over,
               "model": {k: v.clone() for k, v in pair.tnet.state_dict().items()},
               "optimizer": copy.deepcopy(pair.tstate.optimizer.state_dict()),
               "step": pair.tstate.step, "batches": [], "rotations": []}
        step, jstate, _ = jmake_sharded_train_step(pair.jcfg, pair.jenv, pair.jnet, jmesh,
                                                   pair.jstate)
        jms, tms = [], []
        for s in range(STEPS):
            tbatch, jbatch = pair.batch(rng, b, pair.tcfg.learner_muzero_unrolling_step)
            key = jax.random.PRNGKey(20 + s)
            rots = np.asarray(jax.random.randint(key, (b,), 0, pair.jenv.num_rotations()))
            job["batches"].append(tbatch)
            job["rotations"].append(rots)
            jstate, jm = step(jstate, jglobal_batch(jmesh, jbatch), key)
            jms.append(jm)
            tms.append(pair.tstep(pair.tstate, tbatch, rotations=torch.from_numpy(rots.copy())))
        jobs.append(job)
        params = dict(pair.tnet.named_parameters())
        cases[name] = {
            "jmodel": pair._convert(jstate.params, jstate.batch_stats), "jm": jms,
            "tmodel": {k: v.clone() for k, v in pair.tnet.state_dict().items()}, "tm": tms,
            "momentum": {n: pair.tstate.optimizer.state[p]["momentum_buffer"].clone()
                         for n, p in params.items()}}
    ranks = _gloo_jobs(tmp_path_factory.mktemp("dp4"), jobs, WORLD, _STEPS_WORKER)
    return cases, ranks


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_dp4_train_steps_equal_one_process_and_jax_sharded(dp4_steps, case):
    cases, ranks = dp4_steps
    i = list(STEP_CASES).index(case)
    want = cases[case]
    got = ranks[0][i]
    for r in range(1, WORLD):
        assert torch.equal(ranks[r][i]["flat"], got["flat"]), f"{case}: rank {r}'s parameters"
    _close(got["model"], want["tmodel"], f"{case} vs one process")
    _close(got["model"], want["jmodel"], f"{case} vs the JAX sharded step", counts=False)
    _close(got["momentum"], want["momentum"], f"{case}: momentum vs one process")
    for s in range(STEPS):
        tm, jm = want["tm"][s], want["jm"][s]
        assert sorted(got["metrics"][s]) == sorted(tm) == sorted(jm), case
        for k in tm:
            what = f"{case} step {s}: {k}"
            np.testing.assert_allclose(got["metrics"][s][k].numpy(), tm[k].numpy(), atol=ATOL,
                                       rtol=0, err_msg=f"{what} vs one process")
            np.testing.assert_allclose(got["metrics"][s][k].numpy(), np.asarray(jm[k]),
                                       atol=ATOL, rtol=0, err_msg=f"{what} vs the JAX sharded step")
            for r in range(1, WORLD):
                assert torch.equal(ranks[r][i]["metrics"][s][k], got["metrics"][s][k]), (what, r)


@pytest.fixture
def four_cards(monkeypatch):
    """``torch.cuda`` as a host with four cards shows it, without a card;
    no launcher variables."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_local_device_and_init_distributed_take_the_ranks_card(four_cards):
    from minizero_tpu_torch.parallel import distributed
    from minizero_tpu_torch.parallel.mesh import local_device

    for r in range(4):
        four_cards.setenv("LOCAL_RANK", str(r))
        assert local_device() == torch.device("cuda", r)
    assert local_device("cpu") == torch.device("cpu")
    calls = []
    four_cards.setattr(dist, "is_initialized", lambda: False)
    four_cards.setattr(dist, "is_nccl_available", lambda: True)
    four_cards.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    four_cards.setattr(dist, "init_process_group",
                       lambda backend, **kw: calls.append(("init", backend, kw)))
    four_cards.setattr(dist, "get_rank", lambda group=None: 2)
    four_cards.setattr(dist, "get_world_size", lambda group=None: 4)
    four_cards.setenv("RANK", "2")
    four_cards.setenv("WORLD_SIZE", "4")
    four_cards.setenv("LOCAL_RANK", "2")
    four_cards.setenv("MASTER_ADDR", "localhost")
    assert distributed.init_distributed() == (2, 4)
    assert calls == [("set_device", torch.device("cuda", 2)),
                     ("init", "nccl", {"init_method": "env://"})]


def test_multi_device_without_a_launcher_spawns_a_rank_a_card(four_cards, tmp_path):
    from minizero_tpu_torch import __main__ as cli

    spawned = []
    four_cards.setattr(cli, "spawn_ranks", lambda argv, world, device=None:
                       spawned.append((list(argv), world, device)))
    run_dir = str(tmp_path / "run")
    argv = ["-mode", "zero", "-multi_device", "-run_dir", run_dir, "-conf_str",
            "env_name=tictactoe:nn_num_blocks=1:nn_num_hidden_channels=8"]
    assert cli.main(argv) == 0
    assert spawned == [(argv, 4, None)]
    assert not os.path.exists(run_dir), "the parent built a loop of its own"
    # a spawned rank: the launcher's variables for its card, one torch
    # thread, then the CLI again
    from minizero_tpu_torch.parallel import distributed

    ran = []
    four_cards.setattr(cli, "main", lambda a, device=None: ran.append(
        (a, device, {k: os.environ[k] for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE",
                                                 "MASTER_ADDR", "MASTER_PORT")},
         torch.get_num_threads())))
    for name in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT"):
        four_cards.setenv(name, "")  # restored (unset) after the test
    threads = torch.get_num_threads()
    try:
        distributed.spawned_rank(3, argv, 4, 29511, None)
    finally:
        torch.set_num_threads(threads)
    assert ran == [(argv, None, {"RANK": "3", "LOCAL_RANK": "3", "WORLD_SIZE": "4",
                                 "MASTER_ADDR": "localhost", "MASTER_PORT": "29511"}, 1)]


# the CLI as ``python -m minizero_tpu_torch`` runs it (the package's
# ``__main__`` module under the name ``__main__``), on a host that shows
# four cards, with the spawn recorded: argv = repo, run dir
_RUN_AS_MAIN = r"""
import json, runpy, sys
import torch
import torch.multiprocessing
root, run_dir = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
got = {}
torch.cuda.device_count = lambda: 4
torch.multiprocessing.spawn = lambda fn, args=(), nprocs=1, join=True: got.update(
    module=fn.__module__, name=fn.__qualname__, nprocs=nprocs, argv=args[0])
sys.argv = ["minizero_tpu_torch", "-mode", "zero", "-multi_device", "-run_dir", run_dir,
            "-conf_str", "env_name=tictactoe"]
try:
    runpy.run_module("minizero_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert not e.code, e.code
print("SPAWNED " + json.dumps(got), flush=True)
"""


def test_python_m_multi_device_spawns_ranks_that_find_their_entry(tmp_path):
    """Under ``python -m minizero_tpu_torch`` the CLI module is
    ``__main__``; a spawned rank unpickles its entry function by module
    name, and a function of ``__main__`` is not found there (before, every
    rank of ``-mode zero -multi_device`` died with ``AttributeError: Can't
    get attribute '_rank_main'``)."""
    import importlib
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    out = subprocess.run([sys.executable, "-c", _RUN_AS_MAIN, root, str(tmp_path / "run")],
                         cwd=root, env=env, capture_output=True, text=True, timeout=120)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("SPAWNED ")]
    assert out.returncode == 0 and lines, out.stdout[-2000:] + out.stderr[-2000:]
    got = json.loads(lines[0][len("SPAWNED "):])
    assert got["nprocs"] == 4 and got["argv"][:3] == ["-mode", "zero", "-multi_device"], got
    assert got["module"] != "__main__", got
    assert callable(getattr(importlib.import_module(got["module"]), got["name"]))


def _max_gap(got, want):
    """The largest absolute difference over a dict of tensors."""
    return max(float((got[k].double() - want[k].double()).abs().max()) for k in want
               if not k.endswith("num_batches_tracked"))


@pytest.fixture(scope="module")
def dp4_f64_steps(tmp_path_factory):
    """For each case, in float64 and in float32: the port's plain steps,
    ``F64_STEPS`` of them from the state carried over from JAX, and the
    four gloo ranks' dp-4 steps from the same state on the same batches and
    rotations."""
    cases, jobs = {}, []
    rng = np.random.default_rng(13)
    for name, (env_name, over, b, value_size) in STEP_CASES.items():
        pair = _Pair(env_name, over, value_size=value_size, seed=5)
        pair.sync()
        carried = {"model": {k: v.clone() for k, v in pair.tnet.state_dict().items()},
                   "optimizer": copy.deepcopy(pair.tstate.optimizer.state_dict()),
                   "step": pair.tstate.step}
        k = pair.tcfg.learner_muzero_unrolling_step
        batches = [pair.batch(rng, b, k)[0] for _ in range(F64_STEPS)]
        rotations = [rng.integers(0, pair.tenv.num_rotations(), b) for _ in range(F64_STEPS)]
        for dtype in (torch.float64, torch.float32):
            net = create_network(pair.tcfg, pair.spec).to(dtype)
            net.load_state_dict(carried["model"])
            state = init_train_state(pair.tcfg, net)
            # a float32 optimizer loads the carried buffers without a copy
            state.optimizer.load_state_dict(copy.deepcopy(carried["optimizer"]))
            state.step = carried["step"]
            step = make_train_step(pair.tcfg, pair.tenv, net)
            metrics = [step(state, batch, rotations=torch.as_tensor(rots))
                       for batch, rots in zip(batches, rotations)]
            assert next(net.parameters()).dtype == metrics[-1]["loss"].dtype == dtype
            params = dict(net.named_parameters())
            cases[name, dtype] = {
                "model": net.state_dict(), "metrics": metrics,
                "momentum": {n: state.optimizer.state[p]["momentum_buffer"]
                             for n, p in params.items()}}
            jobs.append({"env": env_name, "over": over, "dtype": dtype, **carried,
                         "batches": batches, "rotations": rotations})
    ranks = _gloo_jobs(tmp_path_factory.mktemp("dp4_f64"), jobs, WORLD, _F64_STEPS_WORKER)
    return cases, ranks


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_dp4_train_steps_equal_one_process_in_float64(dp4_f64_steps, case):
    """C11: after 10 steps the float32 dp-4 step and the plain one differ
    by float32's order of summation (the value head's one-channel
    BatchNorm grows a difference a few times a step), here within ATOL;
    in float64 the two agree to 1e-10, so the steps compute the same
    function."""
    cases, ranks = dp4_f64_steps
    gaps = {}
    for i, dtype in enumerate((torch.float64, torch.float32)):
        j = 2 * list(STEP_CASES).index(case) + i
        want, got = cases[case, dtype], ranks[0][j]
        for r in range(1, WORLD):
            assert torch.equal(ranks[r][j]["flat"], got["flat"]), f"{case}: rank {r}"
        assert got["flat"].dtype == dtype
        metrics = max(abs(float(g[key]) - float(w[key]))
                      for g, w in zip(got["metrics"], want["metrics"]) for key in w
                      if w[key].dim() == 0)
        gaps[dtype] = {"model": _max_gap(got["model"], want["model"]),
                       "momentum": _max_gap(got["momentum"], want["momentum"]),
                       "metrics": metrics}
    print(f"C11 {case}: {F64_STEPS} dp-4 steps against the plain step, largest gaps: "
          f"float64 {gaps[torch.float64]}, float32 {gaps[torch.float32]}")
    for what, gap in gaps[torch.float64].items():
        assert gap <= F64_ATOL, f"{case}: float64 {what} differ by {gap}"
    for what, gap in gaps[torch.float32].items():
        assert gap <= ATOL, f"{case}: float32 {what} differ by {gap}"
