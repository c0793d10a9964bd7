"""Mid-training resume in the port, on the CPU: the cases of
``tests/test_resume.py`` on ``fitgnn_tpu_torch``, plus the checkpoint
round trips, ``ScalarWriter.trim_replay`` and the CLI's resume flags.

A killed session taken up from its resume checkpoint (model and Adam
state, best parameters and val loss, the dropout generator's state, the
phase / epoch / run cursor) gives the uninterrupted session's results bit
for bit: one thread, the same ops in the same order.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import fitgnn_tpu_torch.train.loop as loop
from fitgnn_tpu_torch.cli.main import main
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.partition.pipeline import coarsen_and_partition
from fitgnn_tpu_torch.train import checkpoint as ckpt
from fitgnn_tpu_torch.train import steps
from fitgnn_tpu_torch.utils.logging import ScalarWriter

from test_torch_port_curriculum import (CLASSES, _rows, node_data,
                                        toy)  # noqa: F401  (toy: fixture)

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def part(bucket=False):
    x, s, r, y, tr, va, te = node_data(seed=1)
    return coarsen_and_partition(
        x, s, r, y, mode="extra_node", num_classes=CLASSES, train_mask=tr,
        val_mask=va, test_mask=te, seed=1, bucket=bucket,
        reduction=0.9 if bucket else 0.5)


def base_cfg(**kw):
    return loop.NodeTaskConfig(
        layer_name="GCNConv", hidden=8, num_layers=2, out_dim=CLASSES,
        exp_setup="Gc_train_2_Gs_train", epochs1=3, epochs2=4, runs=2,
        seed=3, device="cpu", **kw)


def run(cfg, bucket=False, **kw):
    p = part(bucket)
    return loop.run_node_task(cfg, p.coarse, p.subgraphs, **kw)


def assert_same_runs(a, b):
    assert len(a.runs) == len(b.runs)
    for x, y in zip(a.runs, b.runs):
        assert (x.test_loss, x.test_acc) == (y.test_loss, y.test_acc)


class Crash(RuntimeError):
    pass


def bomb(monkeypatch, name, at, module=loop):
    """``module.name`` raises on its ``at``-th call."""
    orig, calls = getattr(module, name), [0]

    def wrapped(*a, **kw):
        calls[0] += 1
        if calls[0] == at:
            raise Crash("simulated worker crash")
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return lambda: monkeypatch.setattr(module, name, orig)


@pytest.mark.parametrize("bomb_at,bucket,extra", [
    (3, False, {}), (8, False, {}),
    (3, True, {"fused_epochs": True, "eval_chunk": 5}),
    (8, True, {"gradient_method": "MB", "batch_size": 4}),
    (4, False, {"lr2": 0.003})])
def test_resume_matches_uninterrupted(tmp_path, monkeypatch, bomb_at,
                                      bucket, extra):
    """A crash in the Gs eval: at call 3 mid-Gs of run 0, at call 8 in run
    1 (each run evals 4 val and 2 test); the resumed session equals the
    uninterrupted one, the scalar log keeps each (tag, step) once."""
    full = run(base_cfg(**extra), bucket)
    rp = str(tmp_path / "resume")
    cfg = base_cfg(resume_path=rp, checkpoint_every=1,
                   logdir=str(tmp_path / "log"), **extra)
    undo = bomb(monkeypatch, "_gs_eval", bomb_at)
    with pytest.raises(Crash):
        run(cfg, bucket)
    undo()
    assert_same_runs(run(cfg, bucket, verbose=True), full)
    for r in (1, 2):
        with open(tmp_path / "log" / f"run_{r}" / "scalars.jsonl") as f:
            rows = [json.loads(line) for line in f]
        keys = [(row["tag"], row["step"]) for row in rows]
        assert len(keys) == len(set(keys))
        assert {t for t, _ in keys} >= {"Gc_val_loss", "Gs_val_loss",
                                        "Gs_test_acc"}


def test_completed_session_resume_is_noop_fast(tmp_path, monkeypatch):
    """Resuming a finished session builds no model and reports the stored
    results."""
    cfg = base_cfg(resume_path=str(tmp_path / "done"), checkpoint_every=2)
    first = run(cfg)
    monkeypatch.setattr(loop, "NodeModel", None)    # would raise if built
    again = run(cfg)
    assert_same_runs(again, first)
    assert [r.test_time for r in again.runs] == [r.test_time
                                                 for r in first.runs]


def test_fresh_run_without_resume_flag_ignores_stale(tmp_path):
    """Without resume_path the loop never reads a stale checkpoint."""
    cfg = base_cfg(resume_path=str(tmp_path / "stale"), checkpoint_every=1)
    first = run(cfg)
    fresh = run(dataclasses.replace(cfg, resume_path=None))
    assert len(fresh.runs) == 2
    assert fresh.runs[0].gs_epoch_seconds     # it trained
    assert_same_runs(fresh, first)


def test_run_boundary_marker_starts_next_run_fresh(tmp_path, monkeypatch):
    """A crash in run 1's Gc phase before any periodic save: the only
    checkpoint is run 0's run-complete marker, so run 1 starts from a
    fresh init and generator and lands on the uninterrupted result."""
    full = run(base_cfg())
    cfg = base_cfg(resume_path=str(tmp_path / "marker"),
                   checkpoint_every=50)
    undo = bomb(monkeypatch, "gc_eval_step", 4, module=steps)
    with pytest.raises(Crash):
        run(cfg)
    undo()
    point = ckpt.load_resume(cfg.resume_path)
    assert (point.phase, point.epoch, point.run) == ("gc", -1, 1)
    assert_same_runs(run(cfg), full)


def test_config_mismatch_raises(tmp_path, monkeypatch):
    cfg = base_cfg(resume_path=str(tmp_path / "fp"), checkpoint_every=1)
    undo = bomb(monkeypatch, "_gs_eval", 3)
    with pytest.raises(Crash):
        run(cfg)
    undo()
    with pytest.raises(ValueError, match="DIFFERENT config"):
        run(dataclasses.replace(cfg, seed=99))


def test_resume_point_holds_the_session(tmp_path, monkeypatch):
    """After Gs epoch 1 of run 0: the cursor, the best val loss, Adam's
    step and the generator's state as the session left them."""
    cfg = base_cfg(resume_path=str(tmp_path / "r"), checkpoint_every=1)
    undo = bomb(monkeypatch, "_gs_eval", 3)
    with pytest.raises(Crash):
        run(cfg)
    undo()
    point = ckpt.load_resume(cfg.resume_path, config_fp=loop._config_fp(cfg))
    assert (point.phase, point.epoch, point.run, point.done) == (
        "gs", 1, 0, [])
    assert np.isfinite(point.best_val)
    assert set(point.best_state) == set(point.model)
    # 3 Gc steps then 2 Gs steps on one optimizer (no lr2)
    assert all(int(s["step"]) == 5
               for s in point.optimizer["state"].values())
    assert point.generator.dtype == torch.uint8


def test_save_and_restore_checkpoint(tmp_path):
    model = NodeModel("GCNConv", 8, 8, 2, CLASSES)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    p = part()
    for _ in range(3):
        steps.gs_train_step_gd(model, opt, p.subgraphs,
                               torch.Generator().manual_seed(0),
                               "classification")
    path = str(tmp_path / "ck" / "state.pt")
    ckpt.save_checkpoint(path, model, opt)
    other = NodeModel("GCNConv", 8, 8, 2, CLASSES)
    other_opt = steps.adam_l2(other.parameters(), 0.01, 5e-4)
    assert ckpt.restore_checkpoint(path, other, other_opt) == 3
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v)
    a, b = opt.state_dict()["state"], other_opt.state_dict()["state"]
    for i in a:
        for k in a[i]:
            assert torch.equal(torch.as_tensor(a[i][k]),
                               torch.as_tensor(b[i][k]))
    params = str(tmp_path / "p" / "model.pt")
    ckpt.save_params(params, model.state_dict())
    back = ckpt.restore_params(params)
    assert all(torch.equal(back[k], v) for k, v in
               model.state_dict().items())
    assert not [f for f in os.listdir(tmp_path / "ck") if "tmp" in f]


def test_load_resume_without_a_checkpoint(tmp_path):
    assert ckpt.load_resume(str(tmp_path / "none")) is None
    os.makedirs(tmp_path / "orbax" / "params")   # another format's files
    assert ckpt.load_resume(str(tmp_path / "orbax")) is None


def test_trim_replay(tmp_path):
    w = ScalarWriter(str(tmp_path), run=1)
    for step in range(4):
        w.add_scalar("Gc_val_loss", 1.0, step)
    for step in range(3):
        w.add_scalar("Gs_val_loss", 2.0, step)
    w.flush()
    w.trim_replay("Gs_", 1, gc_done=True)
    w.add_scalar("Gs_val_loss", 3.0, 1)
    w.trim_replay("Gc_", 2)
    w.close()
    with open(tmp_path / "run_1" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [(r["tag"], r["step"]) for r in rows] == [
        ("Gc_val_loss", 0), ("Gc_val_loss", 1)]


def test_cli_resume_and_stale_checkpoint(toy, monkeypatch):
    """``train --checkpoint_every`` killed mid-Gs, then ``--resume``: the
    row equals an uninterrupted session's.  ``--checkpoint_every`` without
    ``--resume`` deletes a stale checkpoint and starts afresh."""
    common = ["train", "--dataset", "toy", "--data_root",
              str(toy / "dataset"), "--hidden", "16", "--experiment",
              "random", "--device", "cpu", "--runs", "2", "--epochs1", "4",
              "--epochs2", "3", "--exp_setup", "Gc_train_2_Gs_train",
              "--extra_node", "--bucket_sizes"]
    assert main([*common, "--output_dir", "full"]) == 0
    undo = bomb(monkeypatch, "_gs_eval", 2)
    with pytest.raises(Crash):
        main([*common, "--output_dir", "cut", "--checkpoint_every", "1"])
    undo()
    resume_dir = toy / "save" / "node_cls" / "cut" / "resume"
    assert (resume_dir / "state.pt").exists()
    assert main([*common, "--output_dir", "cut", "--checkpoint_every", "1",
                 "--resume"]) == 0
    _, rows = _rows(toy / "results" / "toy.csv")
    assert len(rows) == 2
    for col in ("ave_acc", "best_acc", "top_10_loss", "best_loss"):
        assert rows[0][col] == rows[1][col], col
    # a stale cursor (run 1, Gs) would skip run 0 if it were read
    undo = bomb(monkeypatch, "_gs_eval", 9)
    with pytest.raises(Crash):
        main([*common, "--output_dir", "stale", "--checkpoint_every", "1"])
    undo()
    assert ckpt.load_resume(
        str(toy / "save" / "node_cls" / "stale" / "resume")).run == 1
    calls = []
    orig = loop.run_node_task

    def record(cfg, *a, **kw):
        res = orig(cfg, *a, **kw)
        calls.append(res)
        return res

    monkeypatch.setattr(loop, "run_node_task", record)
    assert main([*common, "--output_dir", "stale", "--checkpoint_every",
                 "1"]) == 0
    assert all(r.gs_epoch_seconds for r in calls[0].runs)   # both trained
