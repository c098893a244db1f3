"""The port's frame window (``learner/frame_window.py``) held against the
JAX package's and against the bytes the search saw.

For every stored position of every record (continuation chunks with their
lead history, terminal chunks, episode restarts) the stack assembled from
the window equals ``AtariVecEnv.features_u8`` before that move, and the
JAX window's assembly of the same records; on the window's device tensor
and on its host-memory path. Records made by the port's host engine (not a
hand-fed drive) assemble exactly too: the engine copies each move's frames
out of the vec env's ring. The ring wraps and evicts its oldest records,
``lookup`` refuses an evicted one, ``retain`` drops what the buffer
evicted (``tests/test_frame_window.py``).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minizero_tpu.learner.frame_window import DeviceFrameWindow, assemble_features as j_assemble
from minizero_tpu_torch.config import algorithm_preset, default_config
from minizero_tpu_torch.envs import atari
from minizero_tpu_torch.learner.frame_window import (
    FrameWindow, assemble_features, assemble_features_host)
from minizero_tpu_torch.selfplay.host_engine import (
    AtariTrajectoryCollector, HostMoveOutput, HostSelfPlayEngine)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_muzero_search import TorchMuZeroParityNet  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _cfg(seqlen=4, n_step=2, unroll=2):
    return default_config("atari", zero_actor_intermediate_sequence_length=seqlen,
                          learner_n_step_return=n_step, learner_muzero_unrolling_step=unroll)


def _drive(seqlen=4, moves=40, batch=2, length=48):
    """Records and their ground-truth stacks from a FakeALE drive."""
    vec = atari.AtariVecEnv(batch, ale_factory=lambda s: atari.FakeALE(seed=s, length=length))
    col = AtariTrajectoryCollector(_cfg(seqlen), vec.spec, batch)
    rs = np.random.RandomState(0)
    gt = [[] for _ in range(batch)]
    records = []
    for _ in range(moves):
        stacks = vec.features_u8()
        frames = vec.newest_frames().copy()
        actions = rs.randint(0, 4, (batch,))
        for i in range(batch):
            gt[i].append(stacks[i])
        rewards = vec.step(actions)
        out = HostMoveOutput(
            action=actions.astype(np.int32), policy_target=np.zeros((batch, 18), np.float32),
            root_value=np.zeros(batch, np.float32), reward=rewards, frames=frames,
            done=vec.terminals(), eval_score=np.zeros(batch, np.float32),
            lives_lost=np.zeros(batch, bool))
        finished, _ = col.add_moves(out)
        for fg in finished:
            records.append((fg.record, np.stack(gt[fg.slot][fg.abs_start:
                                                         fg.abs_start + fg.record.length])))
        for i in vec.reset_done():
            gt[i] = []
    assert records
    return records


def _assembled(fw, rec):
    return fw.assemble(fw.lookup([rec] * rec.length, np.arange(rec.length))).numpy()


@pytest.mark.parametrize("on_device", [True, False])
def test_assembled_stacks_match_selfplay_features_and_jax(on_device):
    records = _drive()
    assert any(r.frame_lead > 0 for r, _ in records) and any(r.frame_lead == 0 for r, _ in records)
    rows = sum(r.frames.shape[0] for r, _ in records)
    fw = FrameWindow(rows, 96, 96, device="cpu", on_device=on_device)
    jfw = DeviceFrameWindow(rows + 64 * len(records), 96, 96, device=False)
    for rec, _ in records:
        fw.add(rec)
        jfw.add(rec)
    for rec, expect in records:
        got = _assembled(fw, rec)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, expect)
        lk = jfw.lookup([rec] * rec.length, np.arange(rec.length))
        want = np.asarray(j_assemble(jnp.asarray(jfw.frames), jnp.asarray(lk["frame_idx"]),
                                     jnp.asarray(lk["frame_valid"]),
                                     jnp.asarray(lk["frame_aplane"])))
        np.testing.assert_array_equal(got, want.astype(np.uint8))


def test_device_and_host_assembly_agree_on_random_plans():
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, size=(30, 96, 96, 3)).astype(np.uint8)
    idx = rng.integers(0, 30, size=(5, 8))
    valid = rng.random((5, 8)) < 0.8
    aplane = rng.integers(0, 256, size=(5, 8)).astype(np.uint8)
    got = assemble_features(torch.from_numpy(frames), torch.from_numpy(idx),
                            torch.from_numpy(valid), torch.from_numpy(aplane))
    np.testing.assert_array_equal(got.numpy(), assemble_features_host(frames, idx, valid, aplane))


def test_engine_records_assemble_what_the_search_saw():
    """The port's host engine over long episodes (chunks of 4, lead
    history): each record's stacks from the window equal the pre-move
    ``features_u8`` of their positions, so frames kept beyond the vec env's
    8-slot ring stay right."""
    over = dict(algorithm_preset("mz", is_atari=True))
    over.update(actor_num_simulation=2, actor_use_dirichlet_noise=False,
                zero_actor_intermediate_sequence_length=4, learner_n_step_return=2,
                learner_muzero_unrolling_step=2)
    cfg = default_config("atari", **over)
    vec = atari.AtariVecEnv(2, ale_factory=lambda s: atari.FakeALE(seed=s, length=96))
    eng = HostSelfPlayEngine(vec, cfg, TorchMuZeroParityNet("atari", atari_mode=True),
                             use_bf16=False, device="cpu")
    col = AtariTrajectoryCollector(cfg, vec.spec, 2)
    fw = FrameWindow(4000, 96, 96, device="cpu")
    gt = [[] for _ in range(2)]
    checked = 0
    for _ in range(30):
        stacks = vec.features_u8()
        for i in range(2):
            gt[i].append(stacks[i])
        finished, _ = col.add_moves(eng.move())
        for fg in finished:
            fw.add(fg.record)
            want = np.stack(gt[fg.slot][fg.abs_start:fg.abs_start + fg.record.length])
            np.testing.assert_array_equal(_assembled(fw, fg.record), want)
            checked += fg.abs_start > 8
        for i in vec.reset_done():
            gt[i] = []
    assert checked > 0


def test_window_wrap_evicts_oldest_and_guards_lookup():
    records = [r for r, _ in _drive(moves=30)]
    one = records[0].frames.shape[0]
    fw = FrameWindow(int(one * 2.5), 96, 96, device="cpu")
    fw.add(records[0])
    fw.add(records[1])
    assert records[0] in fw and records[1] in fw
    fw.add(records[2])  # wraps to row 0 over record 0's rows
    assert records[0] not in fw and records[2] in fw
    with pytest.raises(KeyError):
        fw.lookup([records[0]], np.zeros(1, np.int64))
    fw.lookup([records[2]], np.zeros(1, np.int64))
    with pytest.raises(ValueError):
        FrameWindow(3, 96, 96, device="cpu").add(records[0])


def test_wrapped_window_still_assembles_exactly():
    """A ring a few records long, filled several times over: the live
    records' stacks stay exact after every wrap."""
    records = _drive(moves=40, batch=2, length=48)
    rows = 3 * max(r.frames.shape[0] for r, _ in records)
    fw = FrameWindow(rows, 96, 96, device="cpu")
    live = []
    for rec, expect in records:
        fw.add(rec)
        live = [(r, e) for r, e in live + [(rec, expect)] if r in fw]
        for r, e in live:
            np.testing.assert_array_equal(_assembled(fw, r), e)
    assert len(live) < len(records)


def test_retain_drops_evicted_games():
    records = [r for r, _ in _drive(moves=20)]
    fw = FrameWindow(100000, 96, 96, device="cpu", on_device=False)
    for rec in records:
        fw.add(rec)
    fw.retain(records[1:])
    assert records[0] not in fw and all(r in fw for r in records[1:])
