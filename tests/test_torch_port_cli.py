"""The port's ``infer-baseline`` CLI against the JAX package, on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from fitgnn_tpu.bench.inference import \
    baseline_inference_benchmark as jax_baseline_benchmark
from fitgnn_tpu.data.splits import \
    splits_classification as jax_splits_classification
from fitgnn_tpu.data.splits import splits_regression as jax_splits_regression
from fitgnn_tpu.graph.build import build_graph as jax_build_graph
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.utils.results import INFERENCE_HEADER as JAX_HEADER
from fitgnn_tpu.utils.results import format_row as jax_format_row

from fitgnn_tpu_torch.cli.main import main
from fitgnn_tpu_torch.data.datasets import (DatasetNotFoundError, NodeDataset,
                                            load_node_dataset, save_npz_cache)
from fitgnn_tpu_torch.data.splits import (splits_classification,
                                          splits_regression)
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.utils.results import INFERENCE_HEADER, format_row

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """A 400-node, 4-class community dataset as an npz cache; the working
    directory is ``tmp_path`` so CSVs land there."""
    rng = np.random.default_rng(0)
    n = 400
    r = rng.integers(0, n, 3000)
    s = np.where(rng.random(3000) < 0.8,
                 np.minimum((r // 100) * 100 + rng.integers(0, 100, 3000),
                            n - 1), rng.integers(0, n, 3000))
    y = (np.arange(n) // 100).astype(np.int64)
    x = (rng.standard_normal((n, 12)) + y[:, None] * 0.5).astype(np.float32)
    os.makedirs(tmp_path / "dataset" / "toy")
    save_npz_cache(str(tmp_path / "dataset" / "toy" / "toy.npz"),
                   NodeDataset("toy", x, s, r, y))
    monkeypatch.chdir(tmp_path)
    return tmp_path, NodeDataset("toy", x, s, r, y)


def _run(tmp_path, *extra):
    return main(["infer-baseline", "--dataset", "toy", "--data_root",
                 str(tmp_path / "dataset"), "--hidden", "16",
                 "--num_test_samples", "8", "--experiment", "random",
                 "--device", "cpu", *extra])


def _read_csv(tmp_path):
    with open(tmp_path / "inference_results" / "node_cls.csv") as f:
        return f.read().splitlines()


def test_header_and_row_format_match_jax():
    assert INFERENCE_HEADER == JAX_HEADER
    vals = {"dataset": "d", "hidden": 8, "acc": 0.5, "Extra_Nodes": True}
    assert format_row(INFERENCE_HEADER, vals) == jax_format_row(JAX_HEADER,
                                                                vals)


def test_infer_baseline_writes_row(toy):
    tmp_path, _ = toy
    assert _run(tmp_path) == 0
    lines = _read_csv(tmp_path)
    assert lines[0] == JAX_HEADER and len(lines) == 2
    row = dict(zip(lines[0].split(","), lines[1].split(",")))
    assert row["exp_setup"] == "baseline" and row["num_test_samples"] == "8"
    assert float(row["avg_inf_time"]) > 0
    assert float(row["avg_inf_time_device"]) > 0


def test_infer_baseline_matches_jax_with_converted_params(toy):
    tmp_path, ds = toy
    jm = JaxNodeModel(layer_name="GCNConv", hidden=16, num_layers=2,
                      out_dim=4)
    g = jax_build_graph(ds.x, ds.senders, ds.receivers)
    params = jm.init(jax.random.PRNGKey(3), g.x, g)
    ckpt = str(tmp_path / "model.pt")
    torch.save(params_from_flax(jax.tree_util.tree_map(np.asarray, params)),
               ckpt)
    assert _run(tmp_path, "--checkpoint", ckpt) == 0
    row = dict(zip(JAX_HEADER.split(","), _read_csv(tmp_path)[1].split(",")))

    _, _, test = jax_splits_classification(ds.y, 4, "random", seed=0)
    rep = jax_baseline_benchmark(jm, params, g, test, ds.y, num_samples=8,
                                 seed=0)
    assert float(row["acc"]) == rep.acc
    assert abs(float(row["avg_loss"]) - rep.avg_loss) < 1e-5


def test_cuda_default_raises_without_gpu(toy):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the cuda default is valid here")
    tmp_path, _ = toy
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["infer-baseline", "--dataset", "toy", "--data_root",
              str(tmp_path / "dataset")])


@pytest.mark.parametrize("command", ["train", "infer", "memory", "stats",
                                     "save-graphs"])
def test_unported_subcommands_raise(command):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main([command, "--dataset", "toy"])


def test_graph_tasks_raise(toy):
    tmp_path, _ = toy
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run(tmp_path, "--task", "graph_cls")


def test_splits_match_jax():
    y = np.random.default_rng(1).integers(0, 5, 600)
    for exp in ("random", "few", "ogbn_split"):
        for a, b in zip(splits_classification(y, 5, exp, seed=2),
                        jax_splits_classification(y, 5, exp, seed=2)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(splits_regression(600, 0.3, 0.2, seed=2),
                    jax_splits_regression(600, 0.3, 0.2, seed=2)):
        np.testing.assert_array_equal(a, b)


def test_dataset_loading(toy):
    tmp_path, ds = toy
    got = load_node_dataset("TOY", str(tmp_path / "dataset"))
    np.testing.assert_array_equal(got.x, ds.x)
    np.testing.assert_array_equal(got.senders, ds.senders)
    assert got.train_mask is None and got.num_classes == 4
    with pytest.raises(DatasetNotFoundError):
        load_node_dataset("nope", str(tmp_path))
    for name in ("cora", "random_50"):
        with pytest.raises(NotImplementedError):
            load_node_dataset(name, str(tmp_path))


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of the port pulls in neither JAX nor the
    JAX package."""
    pkg = os.path.join(REPO, "fitgnn_tpu_torch")
    mods = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    code = ("import importlib, sys\n"
            f"for m in {sorted(mods)!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'fitgnn_tpu' or "
            "m.startswith('fitgnn_tpu.')]\n"
            "print(len(sys.modules))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) > 20
