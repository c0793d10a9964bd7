"""The port's FIT-GNN curriculum against the JAX package, on the CPU: the
Gs steps, ``run_node_task`` for each experiment setup, and ``train`` then
``infer`` through the port's CLI.

The same numpy inputs go through both packages, with the JAX package's
initial parameters loaded into the port through ``params_from_flax`` and
dropout off on both sides (rate 0: the JAX ConvStack's ``nn.Dropout(0.0)``
is an identity).  Tolerances: losses, metrics and parameters within rtol
1e-4 and atol 1e-5·max(1, max|ref|) (f32 sums in another order).
"""

import functools
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax

import fitgnn_tpu.train.loop as jax_loop
import fitgnn_tpu.train.steps as jax_steps
from fitgnn_tpu.bench.inference import \
    node_inference_benchmark as jax_node_inference
from fitgnn_tpu.data.splits import \
    splits_classification as jax_splits_classification
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.partition import coarsen_and_partition as jax_partition
from fitgnn_tpu.utils import results as jax_results

import fitgnn_tpu_torch.train.loop as loop
from fitgnn_tpu_torch.cli.main import main
from fitgnn_tpu_torch.data.datasets import NodeDataset, save_npz_cache
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.partition.pipeline import coarsen_and_partition
from fitgnn_tpu_torch.train import steps
from fitgnn_tpu_torch.train.checkpoint import restore_params

torch.set_num_threads(1)

HIDDEN = 16
CLASSES = 4


def close(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


def node_data(n=300, feat=8, seed=0):
    """A community graph whose labels follow the communities."""
    rng = np.random.default_rng(seed)
    e = n * 5
    r = rng.integers(0, n, e)
    s = np.where(rng.random(e) < 0.85,
                 np.minimum((r // 50) * 50 + rng.integers(0, 50, e), n - 1),
                 rng.integers(0, n, e))
    keep = s != r
    y = ((np.arange(n) // 50) % CLASSES).astype(np.int64)
    x = (rng.standard_normal((n, feat)) + 0.7 * y[:, None]).astype(np.float32)
    tr = rng.random(n) < 0.4
    va = ~tr & (rng.random(n) < 0.35)
    te = ~tr & ~va
    return x, s[keep], r[keep], y, tr, va, te


@functools.lru_cache(maxsize=None)
def partitions(mode="plain"):
    x, s, r, y, tr, va, te = node_data()
    kw = dict(mode=mode, num_classes=CLASSES, train_mask=tr, val_mask=va,
              test_mask=te)
    return coarsen_and_partition(x, s, r, y, **kw), jax_partition(
        x, s, r, y, **kw)


def jax_state(layer, batch, seed=0, lr=0.01):
    jm = JaxNodeModel(layer_name=layer, hidden=HIDDEN, num_layers=2,
                      out_dim=CLASSES, dropout_rate=0.0)
    g0 = batch.subgraph(0)
    return jax_steps.create_state(jm, jax.random.PRNGKey(seed), g0.x, g0,
                                  lr=lr, weight_decay=5e-4)


def port_model(layer, params):
    model = NodeModel(layer, 8, HIDDEN, 2, CLASSES, dropout_rate=0.0)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return model


def assert_params_close(model, params):
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k].numpy())


@pytest.mark.parametrize("layer", ["GCNConv", "GATConv"])
@pytest.mark.parametrize("split", ["val", "test"])
def test_gs_eval_step_matches_jax(layer, split):
    part, jpart = partitions("extra_node")
    state = jax_state(layer, jpart.subgraphs)
    loss_j, acc_j = jax_steps.gs_eval_step(state, jpart.subgraphs,
                                           "classification", split=split)
    model = port_model(layer, state.params)
    loss, acc = steps.gs_eval_step(model, part.subgraphs, "classification",
                                   split)
    close(loss, loss_j)
    close(acc, acc_j)


@pytest.mark.parametrize("layer", ["GCNConv", "GATConv"])
def test_gs_train_step_gd_matches_jax(layer):
    part, jpart = partitions()
    state = jax_state(layer, jpart.subgraphs)
    new, loss_j = jax_steps.gs_train_step_gd(
        state, jpart.subgraphs, jax.random.PRNGKey(1), "classification")
    model = port_model(layer, state.params)
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    loss = steps.gs_train_step_gd(model, opt, part.subgraphs, None,
                                  "classification")
    close(loss, loss_j)
    assert_params_close(model, new.params)


@pytest.mark.parametrize("layer", ["GCNConv", "GATConv"])
def test_gs_train_epoch_mb_matches_jax(layer):
    """Chunks of 8 subgraphs in order; the train masks of chunk 1 are
    cleared on both sides, so that chunk leaves parameters and Adam state
    untouched; the last chunk is padded."""
    part, jpart = partitions()
    b, jb = part.subgraphs, jpart.subgraphs
    bs = 8
    assert b.num_subgraphs % bs and b.num_subgraphs > 3 * bs
    tm = b.train_mask.clone()
    tm[bs:2 * bs] = False
    b = b._replace(train_mask=tm)
    jb = jb._replace(train_mask=jax.numpy.asarray(tm.numpy()))
    state = jax_state(layer, jb)
    new, loss_j = jax_steps.gs_train_epoch_mb(
        state, jb, jax.random.PRNGKey(2), "classification", batch_size=bs)
    model = port_model(layer, state.params)
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    loss = steps.gs_train_epoch_mb(model, opt, b, None, "classification",
                                   batch_size=bs)
    close(loss, loss_j)
    assert_params_close(model, new.params)
    n_chunks = -(-b.num_subgraphs // bs)
    assert int(new.step) == n_chunks - 1
    assert all(s["step"] == n_chunks - 1 for s in opt.state.values())


def test_chunk_pad():
    part, _ = partitions()
    b = part.subgraphs
    chunks, k = steps.chunk_pad(b, 16)
    assert k == len(chunks) == -(-b.num_subgraphs // 16)
    assert all(c.num_subgraphs == 16 for c in chunks)
    assert chunks[0].x.data_ptr() == b.x.data_ptr()
    tail = b.num_subgraphs - 16 * (k - 1)
    last = chunks[-1]
    assert not last.train_mask[tail:].any() and not last.n_node[tail:].any()
    np.testing.assert_array_equal(last.x[:tail].numpy(),
                                  b.x[16 * (k - 1):].numpy())


def run_pair(kw, part, jpart, extra=None):
    """``run_node_task`` of both packages on the same partition and config:
    the JAX model with dropout 0, the port's constructor patched to dropout
    0 and to start from the JAX package's initial parameters."""
    inits = []
    create = jax_steps.create_state

    def record(*a, **k):
        st = create(*a, **k)
        inits.append(st.params)
        return st

    with mock.patch.object(jax_loop, "NodeModel",
                           functools.partial(JaxNodeModel, dropout_rate=0.0)), \
            mock.patch.object(jax_steps, "create_state", record):
        ref = jax_loop.run_node_task(jax_loop.NodeTaskConfig(**kw),
                                     jpart.coarse, jpart.subgraphs)

    class FromJax(NodeModel):
        def __init__(self, *a, **k):
            super().__init__(*a, dropout_rate=0.0, **k)

        def reset_parameters(self, generator=None):
            self.load_state_dict(params_from_flax(
                jax.tree_util.tree_map(np.asarray, inits[0])))
            return self

    with mock.patch.object(loop, "NodeModel", FromJax):
        got = loop.run_node_task(
            loop.NodeTaskConfig(**kw, **(extra or {}), device="cpu"),
            part.coarse, part.subgraphs)
    return got, ref


def run_both(setup, layer="GCNConv", gradient_method="GD", lr2=None,
             early_stopping=0, mode="plain", tmp=None):
    """``run_pair`` on the classification partition, 2 + 2 epochs; with
    ``tmp`` the port also logs, saves and writes the intermediate CSV."""
    part, jpart = partitions(mode)
    kw = dict(layer_name=layer, hidden=HIDDEN, num_layers=2,
              out_dim=CLASSES, exp_setup=setup, epochs1=2, epochs2=2,
              lr2=lr2, gradient_method=gradient_method, batch_size=16,
              runs=1, seed=0, early_stopping=early_stopping)
    extra = None if tmp is None else dict(
        logdir=str(tmp / "log"), save_path=str(tmp / "model.pt"),
        run_intermediate_inference=True, intermediate_inference_freq=1,
        intermediate_csv_path=str(tmp / "inter.csv"))
    return run_pair(kw, part, jpart, extra)


@pytest.mark.parametrize("setup,layer,method", [
    ("Gc_train_2_Gs_infer", "GCNConv", "GD"),
    ("Gs_train_2_Gs_infer", "GCNConv", "GD"),
    ("Gc_train_2_Gs_train", "GCNConv", "GD"),
    ("Gc_train_2_Gs_train", "GCNConv", "MB"),
    ("Gc_train_2_Gs_train", "GATConv", "GD"),
    ("Gs_train_2_Gs_infer", "GATConv", "MB")])
def test_run_node_task_matches_jax(setup, layer, method):
    got, ref = run_both(setup, layer, method)
    assert len(got.runs) == len(ref.runs) == 1
    close(got.runs[0].test_loss, ref.runs[0].test_loss)
    close(got.runs[0].test_acc, ref.runs[0].test_acc)
    assert got.runs[0].test_time > 0
    uses_gc = setup != "Gs_train_2_Gs_infer"
    assert len(got.runs[0].gc_epoch_seconds) == (2 if uses_gc else 0)
    assert len(got.runs[0].gs_epoch_seconds) == (
        0 if setup == "Gc_train_2_Gs_infer" else 2)
    s, sj = got.summary, ref.summary
    assert set(s) == set(sj)
    close(s["ave_acc"], sj["ave_acc"])


def test_run_node_task_lr2_and_outputs_match_jax(tmp_path):
    """``lr2``'s fresh optimizer at the boundary, the intermediate CSV, the
    scalar log and the saved best parameters."""
    got, ref = run_both("Gc_train_2_Gs_train", lr2=0.003, tmp=tmp_path)
    close(got.runs[0].test_loss, ref.runs[0].test_loss)
    with open(tmp_path / "inter.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == "epoch,test_loss,test_acc,test_time"
    assert len(lines) == 3
    log = tmp_path / "log" / "run_1" / "scalars.jsonl"
    tags = {line.split('"tag": "')[1].split('"')[0]
            for line in log.read_text().splitlines()}
    assert {"Gc_train_loss", "Gc_val_loss", "Gs_val_loss",
            "Gs_test_acc"} <= tags
    sd = restore_params(str(tmp_path / "model.pt"))
    assert all(torch.isfinite(v).all() for v in sd.values())


def test_run_node_task_early_stopping_matches_jax():
    got, ref = run_both("Gc_train_2_Gs_train", early_stopping=1)
    close(got.runs[0].test_loss, ref.runs[0].test_loss)


def test_run_node_task_regression_matches_jax():
    """Regression: masked L1 in both phases, the std-normalized L1 as the
    metric, coarse targets C·y."""
    x, s, r, y, tr, va, te = node_data(seed=7)
    y = (x[:, 0] + 0.1 * y).astype(np.float32)
    kw = dict(task="regression", train_mask=tr, val_mask=va, test_mask=te)
    cfg = dict(layer_name="GCNConv", hidden=HIDDEN, num_layers=2,
               task="regression", out_dim=1,
               exp_setup="Gc_train_2_Gs_train", epochs1=2, epochs2=2,
               runs=1, seed=0)
    got, ref = run_pair(cfg, coarsen_and_partition(x, s, r, y, **kw),
                        jax_partition(x, s, r, y, **kw))
    close(got.runs[0].test_loss, ref.runs[0].test_loss)
    close(got.runs[0].test_acc, ref.runs[0].test_acc)
    close(got.summary["best_metric"], ref.summary["best_metric"])


@pytest.mark.parametrize("field,value", [
    ("bucket_sizes", True), ("eval_chunk", 8), ("fused_epochs", True),
    ("resume_path", "r"), ("checkpoint_every", 2), ("num_devices", 2)])
def test_run_node_task_refuses_unported_options(field, value):
    part, _ = partitions()
    cfg = loop.NodeTaskConfig(device="cpu", **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loop.run_node_task(cfg, part.coarse, part.subgraphs)


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """A 300-node, 4-class community dataset as an npz cache; the working
    directory is ``tmp_path`` so CSVs and checkpoints land there."""
    x, s, r, y, _, _, _ = node_data(seed=5)
    os.makedirs(tmp_path / "dataset" / "toy")
    save_npz_cache(str(tmp_path / "dataset" / "toy" / "toy.npz"),
                   NodeDataset("toy", x, s, r, y))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], [dict(zip(lines[0].split(","), line.split(",")))
                      for line in lines[1:]]


@pytest.mark.parametrize("layer", ["GCNConv", "GATConv"])
def test_cli_train_then_infer_on_npz_toy(toy, layer):
    common = ["--dataset", "toy", "--data_root", str(toy / "dataset"),
              "--hidden", "16", "--experiment", "random", "--device", "cpu",
              "--layer_name", layer]
    assert main(["train", "--runs", "2", "--epochs1", "15", "--epochs2",
                 "10", "--exp_setup", "Gc_train_2_Gs_train", "--extra_node",
                 *common]) == 0
    header, rows = _rows(toy / "results" / "toy.csv")
    assert header == jax_results.TRAIN_NODE_CLS_HEADER and len(rows) == 1
    assert rows[0]["exp_setup"] == "Gc_train_2_Gs_train"
    assert rows[0]["extra_nodes"] == "True" and rows[0]["runs"] == "2"
    assert float(rows[0]["best_acc"]) > 0.5
    assert (toy / "save" / "node_cls" / "out" / "model.pt").exists()
    assert main(["infer", "--num_test_samples", "32", "--extra_node",
                 *common]) == 0
    header, rows = _rows(toy / "inference_results" / "node_cls.csv")
    assert header == jax_results.INFERENCE_HEADER
    row = rows[-1]
    assert row["exp_setup"] == "fitgnn" and row["num_test_samples"] == "32"
    assert float(row["avg_inf_time"]) > 0
    assert float(row["avg_inf_time_device"]) > 0
    # trained weights (random ones score about 1/4 on 4 classes)
    assert float(row["acc"]) > 0.5


def test_cli_train_then_infer_on_random_ring(toy):
    common = ["--dataset", "random_300", "--hidden", "16", "--device",
              "cpu"]
    for setup, method in (("Gc_train_2_Gs_infer", "GD"),
                          ("Gs_train_2_Gs_infer", "MB"),
                          ("Gc_train_2_Gs_train", "MB")):
        assert main(["train", "--runs", "1", "--epochs1", "2", "--epochs2",
                     "2", "--exp_setup", setup, "--gradient_method", method,
                     "--batch_size", "32", *common]) == 0
    header, rows = _rows(toy / "results" / "random_300.csv")
    assert header == jax_results.TRAIN_NODE_CLS_HEADER and len(rows) == 3
    assert all(float(r["best_acc"]) == 1.0 for r in rows)   # one class
    assert main(["infer", "--num_test_samples", "8", *common]) == 0
    _, rows = _rows(toy / "inference_results" / "node_cls.csv")
    assert rows[-1]["exp_setup"] == "fitgnn"
    assert float(rows[-1]["acc"]) == 1.0


def test_cli_train_then_infer_node_reg(toy):
    common = ["--dataset", "toy", "--data_root", str(toy / "dataset"),
              "--hidden", "16", "--task", "node_reg", "--device", "cpu"]
    assert main(["train", "--runs", "1", "--epochs1", "5", "--epochs2", "5",
                 "--exp_setup", "Gc_train_2_Gs_train", "--cluster_node",
                 *common]) == 0
    header, rows = _rows(toy / "results" / "toy.csv")
    assert header == jax_results.TRAIN_NODE_REG_HEADER and len(rows) == 1
    assert np.isfinite(float(rows[0]["best_loss"]))
    assert main(["infer", "--num_test_samples", "8", "--cluster_node",
                 *common]) == 0
    _, rows = _rows(toy / "inference_results" / "node_reg.csv")
    assert np.isfinite(float(rows[-1]["avg_loss"]))


def test_cli_infer_matches_jax_with_converted_params(toy):
    """The subgraph benchmark serves the same sampled nodes from the same
    subgraphs as the JAX package's: equal accuracy and loss."""
    x, s, r, y, _, _, _ = node_data(seed=5)
    _, _, test = jax_splits_classification(y, CLASSES, "random", seed=0)
    jpart = jax_partition(x, s, r, y, num_classes=CLASSES, test_mask=test)
    jm = JaxNodeModel(layer_name="GCNConv", hidden=16, num_layers=2,
                      out_dim=CLASSES)
    g0 = jpart.subgraphs.subgraph(0)
    params = jm.init(jax.random.PRNGKey(3), g0.x, g0)
    ckpt = str(toy / "model.pt")
    torch.save(params_from_flax(jax.tree_util.tree_map(np.asarray, params)),
               ckpt)
    assert main(["infer", "--dataset", "toy", "--data_root",
                 str(toy / "dataset"), "--hidden", "16", "--experiment",
                 "random", "--num_test_samples", "24", "--device", "cpu",
                 "--checkpoint", ckpt]) == 0
    _, rows = _rows(toy / "inference_results" / "node_cls.csv")
    rep = jax_node_inference(jm, params, jpart.subgraphs, jpart.parent,
                             test, y, num_samples=24, seed=0)
    assert float(rows[-1]["acc"]) == rep.acc
    assert abs(float(rows[-1]["avg_loss"]) - rep.avg_loss) < 1e-5
