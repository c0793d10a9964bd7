"""The distributed curriculum end to end: ``run_node_task(num_devices=4,
num_hosts=2)`` in one gloo world of 4 ranks (``torch_port_dist_worker.py``),
on the port's partitions of the JAX tests' SBM graph (classification) and
regression graph, hidden 32, 30 + 30 epochs as the JAX package's
``tests/test_dist_curriculum.py`` and ``tests/test_dist_regression.py``
run theirs.

Dropout's random streams differ from the JAX package's, so each run is
held to what those tests hold: ``Gc_train_2_Gs_train`` in GD and
``Gs_train_2_Gs_infer`` in MB reach an accuracy above 0.5 (chance 0.25)
and a normalized L1 below 1 (the predict-the-mean baseline), and so does
``Gc_train_2_Gs_infer`` (classification).  Every rank ends with the same
parameters and the same test (loss, metric).  Under
``num_devices > 1`` the hierarchical Gc phase comes before
``fused_epochs`` (the same run with it, bit for bit), and a session cut
before its Gs epoch 2's val eval and taken up from its resume checkpoint
(rank 0 writes it, every rank reads it) ends as the uninterrupted one,
bit for bit.  At one rank (``distributed=True`` in a one-rank gloo group
of this process) the distributed path matches the single-device run
within rtol 1e-4: the same dropout masks, the Gs side the same ops.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fitgnn_tpu_torch.parallel import initialize_distributed
from fitgnn_tpu_torch.train import loop

from torch_port_dist_curriculum_cases import close, out_dim, partitions
from torch_port_dist_worker import World

torch.set_num_threads(1)

EPOCHS = 30
# (name, task, exp_setup, gradient_method, extra config)
RUNS = [("cls_gd", "classification", "Gc_train_2_Gs_train", "GD", {}),
        ("cls_mb", "classification", "Gs_train_2_Gs_infer", "MB", {}),
        ("reg_gd", "regression", "Gc_train_2_Gs_train", "GD", {}),
        ("reg_mb", "regression", "Gs_train_2_Gs_infer", "MB", {}),
        ("cls_gc_infer", "classification", "Gc_train_2_Gs_infer", "GD", {}),
        ("cls_gd_fused", "classification", "Gc_train_2_Gs_train", "GD",
         dict(fused_epochs=True))]


def config(task, setup, method, extra) -> dict:
    return dict(layer_name="GCNConv", hidden=32, num_layers=2, task=task,
                out_dim=out_dim(task), exp_setup=setup, epochs1=EPOCHS,
                epochs2=EPOCHS, gradient_method=method, batch_size=16,
                runs=1, seed=0, num_devices=4, num_hosts=2, **extra)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_run")
    cases = []
    for name, task, setup, method, extra in RUNS:
        part, _ = partitions(task)
        cases.append((name, dict(kind="run", cfg=config(task, setup, method,
                                                        extra),
                                 coarse=part.coarse,
                                 batches=part.subgraphs)))
    part, _ = partitions("classification")
    cases.append(("cls_gd_resumed", dict(
        kind="run", cut=3, coarse=part.coarse, batches=part.subgraphs,
        cfg=config("classification", "Gc_train_2_Gs_train", "GD",
                   dict(resume_path=str(tmp / "resume"),
                        checkpoint_every=1)))))
    w = World(cases, tmp)
    yield w
    w.wait()


def same_on_every_rank(results):
    first = results[0]
    for r in results[1:]:
        assert r["test"] == first["test"]
        assert set(r["params"]) == set(first["params"])
        for k, v in first["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
    return first


@pytest.mark.parametrize("run", RUNS[:5], ids=[r[0] for r in RUNS[:5]])
def test_distributed_curriculum_learns(world, run):
    name, task, setup, method, _ = run
    r = same_on_every_rank(world.results(name))
    loss, metric = r["test"]
    assert np.isfinite(loss) and np.isfinite(metric)
    assert r["epochs"] == (EPOCHS if setup.startswith("Gc_train") else 0,
                           EPOCHS if "Gs_train" in setup else 0)
    if task == "classification":
        assert metric > 0.5, f"{name}: accuracy {metric} (chance 0.25)"
    else:
        assert metric < 1.0, f"{name}: normalized L1 {metric}"


@pytest.mark.parametrize("name", ["cls_gd_fused", "cls_gd_resumed"])
def test_distributed_curriculum_matches_plain_run(world, name):
    """``fused_epochs`` ignored under the hierarchical Gc phase; a cut
    session resumed: each bit for bit the plain run ``cls_gd``."""
    ref = same_on_every_rank(world.results("cls_gd"))
    got = same_on_every_rank(world.results(name))
    assert got["test"] == ref["test"]
    for k, v in ref["params"].items():
        np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
    if name == "cls_gd_fused":
        assert got["epochs"] == ref["epochs"]
    else:       # the resumed session ran Gs epochs 2 on
        assert got["epochs"] == (0, EPOCHS - 2)


def test_distributed_path_at_one_rank_matches_single_device(tmp_path):
    part, _ = partitions("classification")
    cfg = config("classification", "Gc_train_2_Gs_train", "GD", {})
    cfg.update(num_devices=1, num_hosts=1, epochs1=3, epochs2=3,
               device="cpu")
    ref = loop.run_node_task(loop.NodeTaskConfig(**cfg), part.coarse,
                             part.subgraphs).runs[0]
    initialize_distributed(torch.device("cpu"), f"file://{tmp_path}/store",
                           0, 1)
    try:
        got = loop.run_node_task(loop.NodeTaskConfig(**cfg,
                                                     distributed=True),
                                 part.coarse, part.subgraphs).runs[0]
    finally:
        dist.destroy_process_group()
    close([got.test_loss, got.test_acc], [ref.test_loss, ref.test_acc])
    assert (len(got.gc_epoch_seconds), len(got.gs_epoch_seconds)) == (3, 3)
