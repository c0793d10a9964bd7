"""Layer-0 pre-aggregation in the port, SAGE and GIN through the curriculum,
and the CLI's SAGE, GIN and ``--preaggregate`` runs, against the JAX
package on the CPU.

Pre-aggregation is checked as ``tests/test_preagg.py`` checks it on the
JAX side: the input equals the JAX package's ``preaggregate_input``; the
pre-aggregated model's forward and gradients equal the plain model's with
the same parameters and the JAX pre-aggregated model's; the state-dict keys
and shapes are the plain model's.  ``run_node_task`` runs SAGE and GIN on
one pad and on size buckets from the JAX package's initial parameters,
dropout off.  The CLI runs on small npz datasets with ``--device cpu``.

Tolerances: inputs and forwards within rtol 1e-5 and atol
1e-6·max(1, max|ref|); gradients, losses and metrics within rtol 1e-4
and atol 1e-5·max(1, max|ref|) (f32 sums in another order).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.graph.build import build_graph as jax_build_graph
from fitgnn_tpu.graph.optimize import \
    build_optimized_graph as jax_build_optimized_graph
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.models.models import \
    preaggregate_input as jax_preaggregate_input
from fitgnn_tpu.partition import coarsen_and_partition as jax_partition
from fitgnn_tpu.train.losses import masked_nll as jax_masked_nll
from fitgnn_tpu.utils import results as jax_results

import fitgnn_tpu_torch.train.loop as loop
from fitgnn_tpu_torch.cli.main import main
from fitgnn_tpu_torch.graph.build import build_graph
from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import NodeModel, preaggregate_input
from fitgnn_tpu_torch.partition.pipeline import coarsen_and_partition
from fitgnn_tpu_torch.train.checkpoint import restore_params
from fitgnn_tpu_torch.train.losses import masked_nll

from test_torch_port_curriculum import (CLASSES, _rows, node_data,
                                        partitions, run_pair,
                                        toy)  # noqa: F401  (toy: fixture)

torch.set_num_threads(1)

PREAGG = ("GCNConv", "SAGEConv", "GINConv")


def close(got, ref, grad=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=1e-4 if grad else 1e-5,
                               atol=(1e-5 if grad else 1e-6) * scale)


@functools.lru_cache(maxsize=None)
def graphs(layer, kind):
    """(port graph, JAX graph) of one community graph: ``hybrid`` with the
    layer's own operator, ``gcn_operator`` with GCN's (so SAGE and GIN
    aggregate by the segment ops), ``plain`` without an operator."""
    rng = np.random.default_rng(12)
    n, feat = 640, 16
    e = n * 10
    r = rng.integers(0, n, e)
    s = np.where(rng.random(e) < 0.85, np.minimum(
        (r // 128) * 128 + rng.integers(0, 128, e), n - 1),
        rng.integers(0, n, e))
    keep = s != r
    s, r = s[keep], r[keep]
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = rng.integers(0, 4, n)
    mask = rng.random(n) < 0.5
    if kind == "plain":
        return (build_graph(x, s, r, y=y, train_mask=mask),
                jax_build_graph(x, s, r, y=y, train_mask=mask))
    kw = dict(y=y, train_mask=mask, min_block_edges=80,
              layer_name=layer if kind == "hybrid" else "GCNConv")
    gt, _ = build_optimized_graph(x, s, r, **kw)
    gj, _ = jax_build_optimized_graph(x, s, r, **kw)
    return gt, gj


@pytest.mark.parametrize("kind", ["hybrid", "gcn_operator", "plain"])
@pytest.mark.parametrize("layer", PREAGG)
def test_preaggregate_input_matches_jax(layer, kind):
    gt, gj = graphs(layer, kind)
    with torch.no_grad():
        got = preaggregate_input(gt, layer)
    ref = jax_preaggregate_input(gj, layer)
    assert got.shape == ref.shape == (
        gt.num_nodes_padded, (1 if layer == "GCNConv" else 2) * 16)
    close(got, ref)


def _jax_pair(layer, gj):
    reg = JaxNodeModel(layer_name=layer, hidden=32, num_layers=2, out_dim=4,
                       dropout_rate=0.0)
    pre = JaxNodeModel(layer_name=layer, hidden=32, num_layers=2, out_dim=4,
                       dropout_rate=0.0, first_layer_preaggregated=True)
    params = reg.init(jax.random.PRNGKey(3), gj.x, gj)
    if layer == "GINConv":
        p = params["params"]
        params = {"params": {**p, "convs": {**p["convs"], "GINConv_0": {
            **p["convs"]["GINConv_0"], "eps": jnp.float32(0.25)}}}}
    return pre, params


@pytest.mark.parametrize("layer", PREAGG)
def test_preaggregated_model_matches_plain_and_jax(layer):
    """On the layer's hybrid operator: the pre-aggregated model's log-probs
    and the gradient of every parameter (GIN's ``eps`` at 0.25 included)
    equal the plain model's with the same parameters and the JAX
    pre-aggregated model's; the state dicts have the same keys and
    shapes."""
    gt, gj = graphs(layer, "hybrid")
    pre_j, params = _jax_pair(layer, gj)
    xj = jax_preaggregate_input(gj, layer)

    def loss_j(p):
        return jax_masked_nll(pre_j.apply(p, xj, gj), gj.y, gj.train_mask)

    out_j = pre_j.apply(params, xj, gj)
    grads_j = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss_j)(params)))
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    plain = NodeModel(layer, 16, 32, 2, 4, dropout_rate=0.0)
    pre = NodeModel(layer, 16, 32, 2, 4, dropout_rate=0.0,
                    first_layer_preaggregated=True)
    assert {k: v.shape for k, v in pre.state_dict().items()} == {
        k: v.shape for k, v in plain.state_dict().items()}
    plain.load_state_dict(sd)
    pre.load_state_dict(sd)
    with torch.no_grad():
        xt = preaggregate_input(gt, layer)
    outs, grads = {}, {}
    for name, model, x in (("plain", plain, gt.x), ("pre", pre, xt)):
        out = model(x, gt)
        masked_nll(out, gt.y, gt.train_mask).backward()
        outs[name] = out.detach()
        grads[name] = {k: p.grad for k, p in model.named_parameters()}
    close(outs["pre"], outs["plain"])
    close(outs["pre"], out_j)
    for k, v in grads["plain"].items():
        close(grads["pre"][k], v, grad=True)
        close(grads["pre"][k], grads_j[k].numpy(), grad=True)


def test_preaggregation_refuses_gat():
    with pytest.raises(ValueError, match="GCN/SAGE/GIN"):
        NodeModel("GATConv", 8, 16, 2, 3, first_layer_preaggregated=True)
    gt, _ = graphs("GCNConv", "plain")
    with pytest.raises(ValueError, match="GATConv"):
        preaggregate_input(gt, "GATConv")


# --- the curriculum -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def bucketed_partitions():
    x, s, r, y, tr, va, te = node_data()
    kw = dict(mode="extra_node", reduction=0.9, num_classes=CLASSES,
              train_mask=tr, val_mask=va, test_mask=te, bucket=True)
    return coarsen_and_partition(x, s, r, y, **kw), jax_partition(
        x, s, r, y, **kw)


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("layer", ["SAGEConv", "GINConv"])
def test_run_node_task_matches_jax(layer, bucket):
    """``Gc_train_2_Gs_train`` in GD, 2 + 2 epochs, from the JAX package's
    initial parameters, dropout off: on one pad (the plain partition) and
    on the 4 size buckets of the extra-node partition (GD over every
    bucket, the chunked eval)."""
    part, jpart = bucketed_partitions() if bucket else partitions()
    if bucket:
        assert len(part.subgraphs) == 4
    kw = dict(layer_name=layer, hidden=16, num_layers=2, out_dim=CLASSES,
              exp_setup="Gc_train_2_Gs_train", epochs1=2, epochs2=2,
              gradient_method="GD", batch_size=16, runs=1, seed=0)
    got, ref = run_pair(kw, part, jpart, dict(eval_chunk=4) if bucket
                        else None)
    close(got.runs[0].test_loss, ref.runs[0].test_loss, grad=True)
    close(got.runs[0].test_acc, ref.runs[0].test_acc, grad=True)


def test_gin_eps_through_fused_phase_and_resume(tmp_path, monkeypatch):
    """GIN's 0-dim ``eps`` through the fused Gc phase's best-parameter
    select and a resume checkpoint: a session cut in its Gs phase and
    taken up equals the uninterrupted one bit for bit, and the fused
    phase equals the per-epoch loop."""
    part, _ = bucketed_partitions()

    def cfg(**kw):
        return loop.NodeTaskConfig(**{
            "layer_name": "GINConv", "hidden": 8, "num_layers": 2,
            "out_dim": CLASSES, "exp_setup": "Gc_train_2_Gs_train",
            "epochs1": 3, "epochs2": 3, "runs": 1, "seed": 1,
            "device": "cpu", "fused_epochs": True, "eval_chunk": 4, **kw})

    def run(c):
        res = loop.run_node_task(c, part.coarse, part.subgraphs).runs[0]
        return res.test_loss, res.test_acc

    full = run(cfg())
    assert run(cfg(fused_epochs=False)) == full
    rp = str(tmp_path / "resume")
    orig, calls = loop._gs_eval, [0]

    def crash(*a, **kw):
        calls[0] += 1
        if calls[0] == 2:
            raise KeyboardInterrupt
        return orig(*a, **kw)

    monkeypatch.setattr(loop, "_gs_eval", crash)
    with pytest.raises(KeyboardInterrupt):
        run(cfg(resume_path=rp, checkpoint_every=1))
    monkeypatch.setattr(loop, "_gs_eval", orig)
    state = torch.load(tmp_path / "resume" / "state.pt", weights_only=True)
    assert state["model"]["convs.layers.0.eps"].shape == ()
    assert state["best_state"]["convs.layers.1.eps"].shape == ()
    assert run(cfg(resume_path=rp, checkpoint_every=1)) == full


# --- the CLI --------------------------------------------------------------

# above the 1/4 of random weights on 4 classes: the runs are a few epochs
# (GIN's unnormalised sums train slowest); parity is held above
CHANCE = 0.3


def _common(toy, layer):
    return ["--dataset", "toy", "--data_root", str(toy / "dataset"),
            "--hidden", "16", "--experiment", "random", "--device", "cpu",
            "--layer_name", layer]


@pytest.mark.parametrize("layer", ["SAGEConv", "GINConv"])
def test_cli_baseline_preaggregate_then_infer_baseline(toy, layer):
    """``train --baseline`` on the layer's hybrid operator, plain and with
    ``--preaggregate``: the same seed and dropout stream, so the rows and
    the saved parameters agree; the pre-aggregated checkpoint has the plain
    model's keys and shapes, and ``infer-baseline`` serves both in the
    plain model."""
    common = _common(toy, layer)
    hybrid = ["--hybrid_spmm", "on", "--hybrid_threshold", "8"]
    for out, extra in (("plain", []), ("pre", ["--preaggregate"])):
        assert main(["train", "--baseline", "--runs", "1", "--epochs1",
                     "15", "--output_dir", out, *hybrid, *extra,
                     *common]) == 0
    header, rows = _rows(toy / "results" / "baseline" / "toy.csv")
    assert header == jax_results.TRAIN_NODE_CLS_HEADER and len(rows) == 2
    assert all(r["layer_name"] == layer for r in rows)
    assert float(rows[0]["best_acc"]) > CHANCE
    close(float(rows[1]["best_loss"]), float(rows[0]["best_loss"]),
          grad=True)
    close(float(rows[1]["best_acc"]), float(rows[0]["best_acc"]), grad=True)
    sd = {out: restore_params(str(toy / "save" / "node_cls" / "baseline" /
                                  out / "model.pt"))
          for out in ("plain", "pre")}
    assert {k: v.shape for k, v in sd["pre"].items()} == {
        k: v.shape for k, v in sd["plain"].items()}
    for k, v in sd["plain"].items():
        close(sd["pre"][k], v, grad=True)
    for out in ("plain", "pre"):
        assert main(["infer-baseline", "--num_test_samples", "32",
                     "--output_dir", out, *common]) == 0
    _, rows = _rows(toy / "inference_results" / "node_cls.csv")
    assert rows[0]["layer_name"] == rows[1]["layer_name"] == layer
    assert rows[0]["acc"] == rows[1]["acc"] and float(rows[0]["acc"]) > CHANCE


def test_cli_gat_ignores_preaggregate(toy):
    """As in the JAX package, ``--preaggregate`` leaves GAT's baseline
    unchanged."""
    common = _common(toy, "GATConv")
    for extra in ([], ["--preaggregate"]):
        assert main(["train", "--baseline", "--runs", "1", "--epochs1", "3",
                     *extra, *common]) == 0
    _, rows = _rows(toy / "results" / "baseline" / "toy.csv")
    assert rows[0]["best_loss"] == rows[1]["best_loss"]


@pytest.mark.parametrize("layer", ["SAGEConv", "GINConv"])
def test_cli_curriculum_then_infer(toy, layer):
    """``train`` in the three setups (GD and MB; ``--preaggregate``, which
    the curriculum ignores), then on size buckets with the chunked eval,
    the fused Gc phase and a resume checkpoint an epoch, again with
    ``--resume`` (the finished session's row again), and ``infer`` from
    the plain and the bucketed checkpoints."""
    common = _common(toy, layer)
    epochs = ["--runs", "1", "--epochs1", "15", "--epochs2", "10"]
    bk = ["--exp_setup", "Gc_train_2_Gs_train", "--extra_node",
          "--bucket_sizes", "--eval_chunk", "8", "--fused_epochs",
          "--checkpoint_every", "1", "--output_dir", "bk"]
    for extra in (["--exp_setup", "Gc_train_2_Gs_infer", "--preaggregate"],
                  ["--exp_setup", "Gs_train_2_Gs_infer", "--gradient_method",
                   "MB", "--batch_size", "16", "--output_dir", "gs"],
                  bk, [*bk, "--resume"]):
        assert main(["train", *epochs, *extra, *common]) == 0
    header, rows = _rows(toy / "results" / "toy.csv")
    assert header == jax_results.TRAIN_NODE_CLS_HEADER and len(rows) == 4
    assert all(r["layer_name"] == layer for r in rows)
    assert float(rows[0]["best_acc"]) > CHANCE
    assert float(rows[2]["best_acc"]) > CHANCE
    assert rows[3]["ave_acc"] == rows[2]["ave_acc"]
    assert (toy / "save" / "node_cls" / "bk" / "resume" / "state.pt").exists()
    for extra in ([], ["--extra_node", "--bucket_sizes", "--output_dir",
                       "bk"]):
        assert main(["infer", "--num_test_samples", "32", *extra,
                     *common]) == 0
    _, rows = _rows(toy / "inference_results" / "node_cls.csv")
    assert len(rows) == 2 and all(r["exp_setup"] == "fitgnn" for r in rows)
    assert all(float(r["acc"]) > CHANCE for r in rows)
