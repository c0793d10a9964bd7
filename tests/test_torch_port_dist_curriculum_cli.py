"""``train --num_devices 4 --num_hosts 2`` (the distributed curriculum)
through the port's CLI against the JAX package's, on the CPU.

Both CLIs run ``Gc_train_2_Gs_train`` with ``--extra_node`` on the same
seeded community dataset (an npz cache the test writes), each in a
working directory of its own: the JAX package in this process on the host
devices ``conftest.py`` forces, the port as the command a user types
(``python -m fitgnn_tpu_torch.cli.main ... --device cpu``), whose CLI
starts 4 gloo ranks itself, while the JAX package's runs.  Dropout's
random streams differ, so the rows are held against each other on every
column but the metrics and the time.  Held too: rank 0 alone partitions
(the others load its partition from the cache), the checkpoint that
``infer`` then serves (trained: accuracy above chance), a regression
row in MB (``Gs_train_2_Gs_infer``, GAT on one host of four ranks), the
refusal of P that H does not divide and ``--device cuda`` with fewer
cards than ranks, both before any rank starts.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fitgnn_tpu.cli.main import main as jax_main
from fitgnn_tpu.utils import results as jax_results

from fitgnn_tpu_torch.cli.main import main
from fitgnn_tpu_torch.data.datasets import NodeDataset, save_npz_cache

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the columns dropout's random streams move
MOVING = ("ave_acc", "ave_time", "top_10_acc", "best_acc", "top_10_loss",
          "best_loss")

CLS = ("--dataset", "toy", "--exp_setup", "Gc_train_2_Gs_train",
       "--num_devices", "4", "--num_hosts", "2")
REG = ("--dataset", "toyr", "--task", "node_reg", "--layer_name", "GATConv",
       "--exp_setup", "Gs_train_2_Gs_infer", "--gradient_method", "MB",
       "--batch_size", "16", "--num_devices", "4")


def _argv(work, *flags):
    return ["train", "--data_root", str(work / "dataset"), "--experiment",
            "random", "--extra_node", "--hidden", "16", "--runs", "1",
            "--epochs1", "2", "--epochs2", "2", *flags]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """``toy`` (3 classes) and ``toyr`` (float targets), 256 nodes in
    communities of 32, under ``dataset/``; the port's two commands started
    in ``port/`` and ``port_reg/``, the JAX package's directory ``jax/``."""
    root = tmp_path_factory.mktemp("dist_curriculum_cli")
    rng = np.random.default_rng(5)
    n, comm = 256, 32
    r = rng.integers(0, n, n * 6)
    s = np.where(rng.random(n * 6) < 0.8, (r // comm) * comm
                 + rng.integers(0, comm, n * 6), rng.integers(0, n, n * 6))
    y = ((np.arange(n) // comm) % 3).astype(np.int64)
    x = (rng.standard_normal((n, 12)) + y[:, None]).astype(np.float32)
    yr = (x[:, 0] + 0.1 * rng.standard_normal(n)).astype(np.float32)
    for name, yy in (("toy", y), ("toyr", yr)):
        os.makedirs(root / "dataset" / name)
        save_npz_cache(str(root / "dataset" / name / f"{name}.npz"),
                       NodeDataset(name, x, s, r, yy))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs = {}
    for d, flags in (("port", CLS), ("port_reg", REG)):
        os.makedirs(root / d)
        procs[d] = subprocess.Popen(
            [sys.executable, "-m", "fitgnn_tpu_torch.cli.main",
             *_argv(root, *flags, "--device", "cpu")], cwd=root / d,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    os.makedirs(root / "jax")
    yield root, procs
    for p in procs.values():
        p.kill()
        p.wait()


def _port_ran(procs, d):
    out, _ = procs[d].communicate(timeout=300)
    assert procs[d].returncode == 0, out[-3000:]
    return out


def _row(path):
    with open(path) as f:
        head, *rows = f.read().splitlines()
    assert len(rows) == 1
    return head, dict(zip(head.split(","), rows[0].split(",")))


def test_dist_curriculum_row_and_checkpoint_match_jax(work, monkeypatch):
    work, procs = work
    monkeypatch.chdir(work / "jax")
    assert jax_main(_argv(work, *CLS)) == 0
    out = _port_ran(procs, "port")
    # one rank partitioned; the other three loaded its partition
    assert out.count("partition: ") == 1, out[-3000:]
    assert out.count("partition artifacts loaded from cache") == 3
    assert "[Gc hier] epoch 0" in out and "[Gs] epoch 1" in out
    rel = os.path.join("results", "toy.csv")
    head, row = _row(work / "port" / rel)
    jax_head, jax_row = _row(work / "jax" / rel)
    assert head == jax_head == jax_results.TRAIN_NODE_CLS_HEADER
    assert row["exp_setup"] == "Gc_train_2_Gs_train"
    for k in head.split(","):
        if k not in MOVING:
            assert row[k] == jax_row[k], k
    for k in MOVING:
        assert np.isfinite(float(row[k].split(" ")[0])), k
    # the checkpoint rank 0 saved: infer serves it, trained
    monkeypatch.chdir(work / "port")
    assert main(["infer", "--data_root", str(work / "dataset"), "--dataset",
                 "toy", "--experiment", "random", "--extra_node",
                 "--hidden", "16", "--num_test_samples", "32",
                 "--device", "cpu"]) == 0
    with open(work / "port" / "inference_results" / "node_cls.csv") as f:
        inf = dict(zip(*(line.split(",") for line in f.read().splitlines())))
    assert inf["exp_setup"] == "fitgnn"
    assert float(inf["acc"]) > 0.45       # chance is 1/3


def test_dist_curriculum_regression_row(work):
    """GAT regression in MB over one host of four ranks (no Gc phase):
    the regression header, a finite normalized L1."""
    work, procs = work
    out = _port_ran(procs, "port_reg")
    assert "[Gs] epoch 1" in out and "[Gc" not in out
    head, row = _row(work / "port_reg" / "results" / "toyr.csv")
    assert head == jax_results.TRAIN_NODE_REG_HEADER
    assert (row["layer_name"], row["extra_nodes"]) == ("GATConv", "True")
    assert np.isfinite(float(row["best_loss"]))


def test_dist_curriculum_refusals(work, tmp_path, monkeypatch):
    work = work[0]
    monkeypatch.chdir(tmp_path)
    base = _argv(work, "--dataset", "toy")
    with pytest.raises(SystemExit,
                       match="--num_devices 3 must divide by --num_hosts 2"):
        main([*base, "--num_devices", "3", "--num_hosts", "2", "--device",
              "cpu"])
    if torch.cuda.device_count() < 4:
        with pytest.raises(SystemExit,
                           match=r"num_devices=4 but only \d+ CUDA devices"):
            main([*base, "--num_devices", "4", "--device", "cuda"])
    assert not os.path.exists("results")          # no rank ran
