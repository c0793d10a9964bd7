"""The port's ``memory``, ``stats`` and ``save-graphs`` subcommands against
the JAX package's, on the CPU.

Both CLIs run on the same seeded datasets (a 400-node community graph with
class labels, the same graph with float targets, and 24 small graphs), each
in a working directory of its own, and the rows they append to
``memory_usage.csv`` and ``dataset_info.csv`` are compared as strings, as
are the lines ``memory`` and ``save-graphs`` print.  The byte accounting
and the homophily measures are also held against the JAX package's
functions directly.  ``save-graphs`` warms the port's artifact cache, which
``memory`` and ``train`` then load without partitioning again.
"""

import os

import numpy as np
import pytest
import torch

from fitgnn_tpu.bench import memory as jax_memory
from fitgnn_tpu.cli.main import main as jax_main
from fitgnn_tpu.data import stats as jax_stats
from fitgnn_tpu.utils.results import MEMORY_HEADER as JAX_MEMORY_HEADER
from fitgnn_tpu.utils.results import format_row as jax_format_row

from fitgnn_tpu_torch.bench import memory
from fitgnn_tpu_torch.cli.main import main
from fitgnn_tpu_torch.data import stats
from fitgnn_tpu_torch.data.datasets import NodeDataset, save_npz_cache
from fitgnn_tpu_torch.data.synthetic import random_graph_dataset
from fitgnn_tpu_torch.partition import pipeline
from fitgnn_tpu_torch.utils.results import MEMORY_HEADER, format_row

torch.set_num_threads(1)


def _community(seed=0, n=400):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 3000)
    s = np.where(rng.random(3000) < 0.8,
                 np.minimum((r // 100) * 100 + rng.integers(0, 100, 3000),
                            n - 1), rng.integers(0, n, 3000))
    y = (np.arange(n) // 100).astype(np.int64)
    x = (rng.standard_normal((n, 12)) + y[:, None] * 0.5).astype(np.float32)
    return x, s, r, y


@pytest.fixture
def work(tmp_path, monkeypatch):
    """``toy`` (4 classes), ``toyr`` (float targets) and ``toyg`` (24
    graphs) under ``tmp_path/dataset``; the port runs in ``tmp_path/port``
    and the JAX package in ``tmp_path/jax``."""
    x, s, r, y = _community()
    for name, yy in (("toy", y), ("toyr", (y + np.random.default_rng(1)
                                           .standard_normal(len(y)))
                                  .astype(np.float32))):
        os.makedirs(tmp_path / "dataset" / name)
        save_npz_cache(str(tmp_path / "dataset" / name / f"{name}.npz"),
                       NodeDataset(name, x, s, r, yy))
    graphs, gy = random_graph_dataset(num_graphs=24, seed=0)
    os.makedirs(tmp_path / "dataset" / "toyg")
    arr = np.empty(len(graphs), dtype=object)
    for i, g in enumerate(graphs):
        arr[i] = g
    np.savez(str(tmp_path / "dataset" / "toyg" / "toyg_graphs.npz"),
             graphs=arr, y=gy)
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d)
    monkeypatch.chdir(tmp_path / "port")
    return tmp_path


def _both(work, capsys, argv):
    """Run ``argv`` through the port's CLI (``--device cpu``) in ``port/``
    and the JAX package's in ``jax/``: each one's stdout lines."""
    root = ["--data_root", str(work / "dataset"), "--experiment", "random"]
    os.chdir(work / "port")
    capsys.readouterr()
    assert main([*argv, *root, "--device", "cpu"]) == 0
    port = capsys.readouterr().out.splitlines()
    os.chdir(work / "jax")
    assert jax_main([*argv, *root]) == 0
    ref = capsys.readouterr().out.splitlines()
    os.chdir(work / "port")
    return port, ref


def _file(work, side, name):
    with open(work / side / name) as f:
        return f.read()


def test_memory_header_and_row_match_jax():
    assert MEMORY_HEADER == JAX_MEMORY_HEADER
    vals = {"dataset": "d", "task": "node_cls", "type": "full_graph:plain",
            "max_memory_usage_graphs": "1.25"}
    assert format_row(MEMORY_HEADER, vals) == jax_format_row(
        JAX_MEMORY_HEADER, vals)


@pytest.mark.parametrize("n,e,feat,labels", [(0, 0, 1, True),
                                             (400, 3000, 12, True),
                                             (169_344, 1_354_752, 128, False),
                                             (7, 129, 3, True)])
def test_graph_bytes_matches_jax(n, e, feat, labels):
    assert memory.graph_bytes(n, e, feat, labels) == \
        jax_memory.graph_bytes(n, e, feat, labels)


@pytest.mark.parametrize("flags", [
    ["--extra_node"], [], ["--cluster_node"], ["--extra_node",
                                               "--bucket_sizes"]],
    ids=["extra_node", "plain", "cluster_node", "extra_node_buckets"])
def test_memory_rows_match_jax(work, capsys, flags):
    """``memory`` on a node task: the full graph and the largest subgraph
    (across buckets with ``--bucket_sizes``), the CSV and the printed
    lines with their padded MB, string-equal."""
    port, ref = _both(work, capsys, ["memory", "--dataset", "toy", *flags])
    assert port == ref and len(port) == 2
    assert "(padded: " in port[0]
    assert _file(work, "port", "memory_usage.csv") == \
        _file(work, "jax", "memory_usage.csv")


@pytest.mark.parametrize("task", ["graph_cls", "graph_reg"])
def test_graph_memory_rows_match_jax(work, capsys, task):
    """``memory --task graph_*``: the Gs chunk, the Gc chunk and the
    largest molecule, every leaf's bytes counted as the JAX package counts
    its pytree's (the port's int64 labels lie outside both views)."""
    port, ref = _both(work, capsys, ["memory", "--task", task, "--dataset",
                                     "toyg", "--extra_node"])
    assert port == ref and len(port) == 3
    csv = _file(work, "port", "memory_usage.csv")
    assert csv == _file(work, "jax", "memory_usage.csv")
    kinds = [line.split(",")[4] for line in csv.splitlines()[1:]]
    assert kinds == ["chunk_gs:extra_node", "chunk_gc:extra_node",
                     "max_graph:extra_node"]


@pytest.mark.parametrize("task,dataset", [("node_cls", "toy"),
                                          ("node_reg", "toyr")])
def test_stats_rows_match_jax(work, capsys, task, dataset):
    port, ref = _both(work, capsys, ["stats", "--task", task, "--dataset",
                                     dataset])
    assert port == ref
    csv = _file(work, "port", "dataset_info.csv")
    assert csv == _file(work, "jax", "dataset_info.csv")
    row = dict(zip(*(line.split(",") for line in csv.splitlines())))
    assert (row["num_classes"] == "4") == (task == "node_cls")
    assert (row["label_std"] != "") == (task == "node_reg")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("classes", [1, 2, 5])
def test_homophily_measures_match_jax(seed, classes):
    """The three measures and ``node_dataset_stats`` on random graphs with
    self loops, isolated nodes and duplicate edges."""
    rng = np.random.default_rng(seed)
    n = 60
    s, r = rng.integers(0, n - 5, 300), rng.integers(0, n - 5, 300)
    y = rng.integers(0, classes, n)
    x = np.zeros((n, 3), np.float32)
    assert stats.edge_homophily(s, r, y) == jax_stats.edge_homophily(s, r, y)
    for fn in ("node_homophily", "edge_insensitive_homophily"):
        assert getattr(stats, fn)(s, r, y, n) == \
            getattr(jax_stats, fn)(s, r, y, n)
    for cls in (True, False):
        got = stats.node_dataset_stats("g", x, s, r, y, classification=cls)
        ref = jax_stats.node_dataset_stats("g", x, s, r, y,
                                           classification=cls)
        assert got.csv_row() == ref.csv_row()
    assert stats.DatasetStats.CSV_HEADER == jax_stats.DatasetStats.CSV_HEADER


def test_save_graphs_warms_the_port_cache(work, capsys, monkeypatch):
    """``save-graphs`` prints the JAX package's line and computes the
    partition into the port's cache (``saved/fitgnn_tpu_torch``); a second
    ``save-graphs``, then ``memory`` and ``train`` on the same flags load
    it and never partition again."""
    flags = ["--dataset", "toy", "--extra_node", "--bucket_sizes"]
    port, ref = _both(work, capsys, ["save-graphs", *flags])
    assert port == ref and port[0].startswith("partition artifacts cached")
    saved = work / "dataset" / "toy" / "saved" / "fitgnn_tpu_torch"
    assert len(os.listdir(saved)) == 1

    def refuse(*args, **kwargs):
        raise AssertionError("partitioned again: the cache was cold")

    monkeypatch.setattr(pipeline, "coarsen_and_partition", refuse)
    root = ["--data_root", str(work / "dataset"), "--experiment", "random",
            "--device", "cpu"]
    for argv in (["save-graphs"], ["memory"],
                 ["train", "--hidden", "8", "--runs", "1", "--epochs1", "1",
                  "--epochs2", "1", "--exp_setup", "Gc_train_2_Gs_train"]):
        assert main([*argv, *flags, *root]) == 0
        assert "partition artifacts loaded from cache" in \
            capsys.readouterr().err, argv[0]
    assert len(os.listdir(saved)) == 1


@pytest.mark.parametrize("command", ["memory", "stats", "save-graphs"])
def test_tools_raise_on_cuda_without_gpu(work, command):
    """The three subcommands take ``--device`` as every other does: the
    ``cuda`` default raises without a GPU rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([command, "--dataset", "toy", "--data_root",
              str(work / "dataset"), "--experiment", "random"])
