"""The rest of the port's node-task curriculum against the JAX package, on
the CPU: size buckets (``partition/bucketing.py``, the bucketed
partition, the multi-bucket Gs steps, the chunked eval, the bucketed
``infer``), the fused Gc phase, and ``train`` / ``infer`` with the new
flags through the port's CLI.

The same numpy inputs go through both packages, the JAX package's initial
parameters loaded into the port (``params_from_flax``) and dropout off on
both sides where the two are compared.  Partitions and bucket indices
must be equal array for array; losses and metrics agree within rtol 1e-5
(the eval) or 1e-4 (a train step, parameters within atol 1e-6); the fused
Gc phase within rtol 2e-4 (losses) and rtol 1e-3 / atol 1e-5 (parameters)
of ``gc_train_epochs_scan``, as ``tests/test_fused_epochs.py`` holds the
scan to the JAX package's per-epoch loop; against the port's own
per-epoch loop it is equal.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

import fitgnn_tpu.bench.inference as jax_inference
import fitgnn_tpu.train.loop as jax_loop
import fitgnn_tpu.train.steps as jax_steps
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.partition import coarsen_and_partition as jax_partition
from fitgnn_tpu.partition.bucketing import \
    bucket_subgraphs_with_index as jax_bucket
from fitgnn_tpu.partition.subgraphs import SubgraphSpec as JaxSpec
from fitgnn_tpu.utils import results as jax_results

import fitgnn_tpu_torch.bench.inference as inference
import fitgnn_tpu_torch.train.loop as loop
from fitgnn_tpu_torch.cli.main import main
from fitgnn_tpu_torch.graph.container import SubgraphBatch
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.partition.bucketing import (bucket_subgraphs,
                                                  bucket_subgraphs_with_index)
from fitgnn_tpu_torch.partition.pipeline import coarsen_and_partition
from fitgnn_tpu_torch.partition.subgraphs import SubgraphSpec
from fitgnn_tpu_torch.train import steps

from test_torch_port_curriculum import (CLASSES, _rows, node_data, run_pair,
                                        toy)  # noqa: F401  (toy: fixture)

torch.set_num_threads(1)

HIDDEN = 16
FEAT = 8


def assert_close(got, ref, rtol, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for b, jb in zip(got, ref):
        assert isinstance(b, SubgraphBatch)
        for f in jb._fields:
            a, r = getattr(b, f), getattr(jb, f)
            assert (a is None) == (r is None), f
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(r), f)


def hand_specs(sizes=(3, 20, 33, 40, 70, 5, 100, 130, 17), feat=4, seed=0):
    """The same subgraph specs for both packages: nodes in consecutive id
    ranges, random local edges (both directions), a halo node in every
    second subgraph; node counts in four power-of-two classes from 32 up."""
    rng = np.random.default_rng(seed)
    port, ref, off = [], [], 0
    for i, n in enumerate(sizes):
        orig = np.arange(off, off + n)
        consume = np.ones(n, dtype=bool)
        if i % 2 and n > 1:
            consume[-1] = False              # a halo node, owned elsewhere
        off += int(consume.sum())
        e = rng.integers(0, n, (2, 2 * n))
        e = e[:, e[0] != e[1]]
        s, r = np.concatenate([e[0], e[1]]), np.concatenate([e[1], e[0]])
        x = rng.standard_normal((n, feat)).astype(np.float32)
        args = (orig, consume, x, s, r)
        port.append(SubgraphSpec(*args))
        ref.append(JaxSpec(*args))
    y = rng.integers(0, 3, off)
    masks = [rng.random(off) < p for p in (0.4, 0.3, 0.3)]
    return port, ref, y, masks


@pytest.mark.parametrize("max_buckets", [0, 1, 2, 3])
def test_bucket_subgraphs_with_index_matches_jax(max_buckets):
    specs, jspecs, y, (tr, va, te) = hand_specs()
    kw = dict(y=y, train_mask=tr, val_mask=va, test_mask=te,
              max_buckets=max_buckets)
    got, index = bucket_subgraphs_with_index(specs, **kw)
    ref, jindex = jax_bucket(jspecs, **kw)
    assert len(got) == (max_buckets or 4)
    np.testing.assert_array_equal(index, jindex)
    assert_batches_equal(got, ref)
    # the caps ascend, and each spec sits at its index
    caps = [b.num_nodes_padded for b in got]
    assert caps == sorted(caps)
    for i, spec in enumerate(specs):
        b, pos = index[i]
        assert int(got[b].n_node[pos]) == spec.num_nodes
        np.testing.assert_array_equal(
            got[b].orig_idx[pos, :spec.num_nodes].numpy(), spec.orig_idx)


def test_bucket_subgraphs_min_bucket_and_errors():
    specs, jspecs, y, _ = hand_specs()
    got = bucket_subgraphs(specs, y=y, min_bucket=128)
    assert [b.num_subgraphs for b in got] == [8, 1]
    with pytest.raises(ValueError, match="max_buckets"):
        bucket_subgraphs_with_index(specs, max_buckets=-1)


def _cover(batches):
    owned = []
    for b in batches:
        orig, consume = b.orig_idx.numpy(), b.consume_mask.numpy()
        owned.append(orig[consume & (orig >= 0)])
    return np.sort(np.concatenate(owned))


@functools.lru_cache(maxsize=None)
def bucketed(mode="extra_node", reduction=0.5, max_buckets=0,
             regression=False):
    """The bucketed partition of ``node_data`` in both packages."""
    x, s, r, y, tr, va, te = node_data(seed=7 if regression else 0)
    if regression:
        y = (x[:, 0] + 0.1 * y).astype(np.float32)
    kw = dict(mode=mode, reduction=reduction, train_mask=tr, val_mask=va,
              test_mask=te, bucket=True, max_buckets=max_buckets,
              **(dict(task="regression") if regression
                 else dict(num_classes=CLASSES)))
    return coarsen_and_partition(x, s, r, y, **kw), jax_partition(
        x, s, r, y, **kw)


@pytest.mark.parametrize("mode,reduction,max_buckets", [
    ("plain", 0.5, 0), ("plain", 0.9, 0), ("extra_node", 0.5, 0),
    ("extra_node", 0.9, 0), ("extra_node", 0.9, 2), ("cluster_node", 0.9, 0)])
def test_coarsen_and_partition_bucketed_matches_jax(mode, reduction,
                                                     max_buckets):
    part, jpart = bucketed(mode, reduction, max_buckets)
    assert isinstance(part.subgraphs, tuple)
    assert_batches_equal(part.subgraphs, jpart.subgraphs)
    np.testing.assert_array_equal(part.parent, jpart.parent)
    np.testing.assert_array_equal(part.subgraph_index, jpart.subgraph_index)
    assert part.subgraph_index.shape == (part.num_metanodes, 2)
    assert sum(b.num_subgraphs for b in part.subgraphs) == part.num_metanodes
    # the consuming nodes over every bucket are an exact cover
    np.testing.assert_array_equal(_cover(part.subgraphs), np.arange(300))
    if max_buckets:
        assert len(part.subgraphs) <= max_buckets


def test_bucketed_partition_has_several_buckets():
    """The partitions the step tests below run on span 2 and 4 buckets."""
    assert len(bucketed()[0].subgraphs) == 2
    assert len(bucketed("extra_node", 0.9)[0].subgraphs) == 4


def jax_state(layer, batch, out_dim=CLASSES, classify=True, seed=0):
    jm = JaxNodeModel(layer_name=layer, hidden=HIDDEN, num_layers=2,
                      out_dim=out_dim, classify=classify, dropout_rate=0.0)
    g0 = batch.subgraph(0)
    return jax_steps.create_state(jm, jax.random.PRNGKey(seed), g0.x, g0,
                                  lr=0.01, weight_decay=5e-4)


def port_model(layer, params, out_dim=CLASSES, classify=True):
    model = NodeModel(layer, FEAT, HIDDEN, 2, out_dim, classify=classify,
                      dropout_rate=0.0)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return model


def assert_params_close(model, params, rtol=1e-4, atol=1e-6):
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        assert_close(got[k], ref[k].numpy(), rtol, atol)


@pytest.mark.parametrize("layer", ["GCNConv", "GATConv"])
@pytest.mark.parametrize("reduction", [0.5, 0.9])
def test_gs_train_step_gd_multi_matches_jax(layer, reduction):
    part, jpart = bucketed("extra_node", reduction)
    state = jax_state(layer, jpart.subgraphs[0])
    new, loss_j = jax_steps.gs_train_step_gd_multi(
        state, tuple(jpart.subgraphs), jax.random.PRNGKey(1),
        "classification")
    model = port_model(layer, state.params)
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    loss = steps.gs_train_step_gd_multi(model, opt, part.subgraphs, None,
                                        "classification")
    assert_close(loss, loss_j, 1e-4)
    assert_params_close(model, new.params)


@pytest.mark.parametrize("layer", ["GCNConv", "GATConv"])
def test_gs_train_step_gd_multi_equals_single(layer):
    """GD over the buckets equals GD over the single-pad batch, in both
    packages (the JAX package's invariant)."""
    part, jpart = bucketed()
    x, s, r, y, tr, va, te = node_data()
    kw = dict(mode="extra_node", num_classes=CLASSES, train_mask=tr,
              val_mask=va, test_mask=te)
    single, jsingle = (coarsen_and_partition(x, s, r, y, **kw).subgraphs,
                       jax_partition(x, s, r, y, **kw).subgraphs)
    state = jax_state(layer, jsingle)
    m_multi, m_single = (port_model(layer, state.params) for _ in range(2))
    for m, run in ((m_multi, lambda m, o: steps.gs_train_step_gd_multi(
                       m, o, part.subgraphs, None, "classification")),
                   (m_single, lambda m, o: steps.gs_train_step_gd(
                       m, o, single, None, "classification"))):
        run(m, steps.adam_l2(m.parameters(), 0.01, 5e-4))
    j_multi, _ = jax_steps.gs_train_step_gd_multi(
        state, tuple(jpart.subgraphs), jax.random.PRNGKey(0),
        "classification")
    j_single, _ = jax_steps.gs_train_step_gd(
        state, jsingle, jax.random.PRNGKey(0), "classification")
    assert_params_close(m_multi, j_single.params)
    assert_params_close(m_single, j_multi.params)
    for k, v in m_multi.state_dict().items():
        assert_close(v, m_single.state_dict()[k].numpy(), 1e-4, 1e-6)


def test_gd_multi_ignores_loss_reduction_as_the_reference_does():
    """The reference's multi-bucket GD takes no reduction and always means,
    so ``loss_reduction="sum"`` trains on the summed loss with one batch
    and on the mean with buckets, in both packages (ROADMAP.md §3)."""
    part, jpart = bucketed()
    x, s, r, y, tr, va, te = node_data()
    kw = dict(mode="extra_node", num_classes=CLASSES, train_mask=tr,
              val_mask=va, test_mask=te)
    single = coarsen_and_partition(x, s, r, y, **kw).subgraphs
    jsingle = jax_partition(x, s, r, y, **kw).subgraphs
    state = jax_state("GCNConv", jsingle)
    losses = {}
    for red in ("mean", "sum"):
        cfg = loop.NodeTaskConfig(hidden=HIDDEN, out_dim=CLASSES,
                                  loss_reduction=red, device="cpu")
        jcfg = jax_loop.NodeTaskConfig(hidden=HIDDEN, out_dim=CLASSES,
                                       loss_reduction=red)
        for name, batches, jbatches in (
                ("multi", part.subgraphs, tuple(jpart.subgraphs)),
                ("single", (single,), (jsingle,))):
            m = port_model("GCNConv", state.params)
            loss = loop._gs_train_epoch(
                m, steps.adam_l2(m.parameters(), 0.01, 5e-4), batches, None,
                cfg)
            js, jloss = jax_loop._gs_train_epoch(
                state, jbatches, jax.random.PRNGKey(0), jcfg)
            assert_close(loss, jloss, 1e-4)
            assert_params_close(m, js.params)
            losses[name, red] = float(loss)
    count = float(single.train_mask.sum())
    assert_close(losses["single", "sum"], count * losses["single", "mean"],
                 1e-5)
    assert losses["multi", "sum"] == losses["multi", "mean"]
    assert_close(losses["multi", "mean"], losses["single", "mean"], 1e-5)


@pytest.mark.parametrize("regression", [False, True])
@pytest.mark.parametrize("layer", ["GCNConv", "GATConv"])
def test_gs_eval_multi_and_chunked_sums_match_jax(regression, layer):
    part, jpart = bucketed("extra_node", 0.9, regression=regression)
    out_dim, task = (1, "regression") if regression else (CLASSES,
                                                          "classification")
    state = jax_state(layer, jpart.subgraphs[0], out_dim, not regression)
    model = port_model(layer, state.params, out_dim, not regression)
    jb = tuple(jpart.subgraphs)
    for split in ("val", "test"):
        ref = jax_steps.gs_eval_step_multi(state, jb, task, split=split)
        got = steps.gs_eval_step_multi(model, part.subgraphs, task, split)
        for a, b in zip(got, ref):
            assert_close(a, b, 1e-5)
        jsums = [jax_steps.gs_eval_bucket_sums(state, b, task, split=split,
                                               chunk=5) for b in jb]
        sums = [steps.gs_eval_bucket_sums(model, b, task, split, chunk=5)
                for b in part.subgraphs]
        for s, js in zip(sums, jsums):
            for a, b in zip(s, js):
                assert_close(a, b, 1e-5, 1e-5)
        loss, metric = steps.finish_eval_from_sums(task, sums)
        jloss, jmetric = jax_steps.finish_eval_from_sums(task, jsums)
        assert_close(loss, jloss, 1e-5)
        assert_close(metric, jmetric, 1e-5)
        # chunked, per-bucket chunks and whole buckets agree
        chunked = steps.gs_eval_step_multi(model, part.subgraphs, task,
                                           split, chunk=(3, 7, 0, 2))
        for a, b in zip(chunked, got):
            assert_close(a, b.numpy(), 1e-5)


def test_gs_eval_multi_on_one_bucket_equals_gs_eval_step():
    part, _ = bucketed()
    model = NodeModel("GCNConv", FEAT, HIDDEN, 2, CLASSES)
    model.reset_parameters(torch.Generator().manual_seed(0))
    b = part.subgraphs[0]
    for split in ("val", "test"):
        one = steps.gs_eval_step(model, b, "classification", split)
        multi = steps.gs_eval_step_multi(model, (b,), "classification",
                                         split)
        for a, m in zip(one, multi):
            assert_close(m, a.numpy(), 1e-6)


def _coarse():
    part, jpart = bucketed()
    return part.coarse, jpart.coarse


@pytest.mark.parametrize("layer", ["GCNConv", "GATConv"])
def test_gc_train_epochs_fused_equals_per_epoch_loop(layer):
    """Dropout on, the same generator: the fused phase and the per-epoch
    loop are equal on the CPU (losses, best val and parameters).  At lr 0.2
    the val loss turns up before the last epoch, so the best parameters
    are not the last."""
    coarse, _ = _coarse()
    g = coarse.graph
    out = {}
    for fused in (False, True):
        model = NodeModel(layer, FEAT, HIDDEN, 2, CLASSES)
        model.reset_parameters(torch.Generator().manual_seed(0))
        opt = steps.adam_l2(model.parameters(), 0.2, 5e-4)
        gen = torch.Generator().manual_seed(4)
        if fused:
            best, best_val, tr, vl = steps.gc_train_epochs_fused(
                model, opt, g, coarse.y_train, coarse.train_mask,
                coarse.y_val, coarse.val_mask, gen, 9, "classification")
            tr, vl, best_val = tr.tolist(), vl.tolist(), float(best_val)
        else:
            tr, vl, best_val, best = [], [], np.inf, None
            for epoch in range(9):
                tr.append(float(steps.gc_train_step(
                    model, opt, g, coarse.y_train, coarse.train_mask, gen,
                    "classification")))
                v, _ = steps.gc_eval_step(model, g, coarse.y_val,
                                          coarse.val_mask, "classification")
                vl.append(float(v))
                if vl[-1] < best_val or epoch == 0:
                    best_val = vl[-1]
                    best = {k: t.clone() for k, t in
                            model.state_dict().items()}
        out[fused] = (tr, vl, best_val, best, model.state_dict())
    (tr0, vl0, bv0, best0, last0), (tr1, vl1, bv1, best1, last1) = (
        out[False], out[True])
    assert tr0 == tr1 and vl0 == vl1 and bv0 == bv1
    assert min(vl0) == bv0 and vl0.index(bv0) < 8    # the best is inside
    for k in best0:
        assert torch.equal(best0[k], best1[k]), k
        assert torch.equal(last0[k], last1[k]), k


def test_gc_train_epochs_fused_matches_jax_scan():
    coarse, jcoarse = _coarse()
    jm = JaxNodeModel(layer_name="GCNConv", hidden=HIDDEN, num_layers=2,
                      out_dim=CLASSES, dropout_rate=0.0)
    jg = jcoarse.graph
    state = jax_steps.create_state(jm, jax.random.PRNGKey(0), jg.x, jg)
    st, bp, bv, tr, vl = jax_steps.gc_train_epochs_scan(
        state, jg, jcoarse.y_train, jcoarse.train_mask, jcoarse.y_val,
        jcoarse.val_mask, jax.random.PRNGKey(7), 12, "classification")
    model = port_model("GCNConv", state.params)
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    best, best_val, got_tr, got_vl = steps.gc_train_epochs_fused(
        model, opt, coarse.graph, coarse.y_train, coarse.train_mask,
        coarse.y_val, coarse.val_mask, None, 12, "classification")
    assert_close(got_tr, tr, 2e-4)
    assert_close(got_vl, vl, 2e-4)
    assert_close(best_val, bv, 2e-4)
    ref_best = params_from_flax(jax.tree_util.tree_map(np.asarray, bp))
    for k, v in ref_best.items():
        assert_close(best[k], v.numpy(), 1e-3, 1e-5)
    assert_params_close(model, st.params, 1e-3, 1e-5)


def test_run_node_task_fused_equals_per_epoch():
    """Through ``run_node_task``: the same test loss and metric, the fused
    run with no per-epoch times and its phase seconds instead; under
    ``early_stopping`` the fused flag is ignored."""
    part, _ = bucketed()
    res = {}
    for kw in ({}, {"fused_epochs": True},
               {"fused_epochs": True, "early_stopping": 50}):
        cfg = loop.NodeTaskConfig(hidden=HIDDEN, out_dim=CLASSES,
                                  exp_setup="Gc_train_2_Gs_train",
                                  epochs1=4, epochs2=2, device="cpu", **kw)
        res[tuple(kw)] = loop.run_node_task(cfg, part.coarse,
                                            part.subgraphs).runs[0]
    plain, fused, stopped = res[()], res[("fused_epochs",)], res[
        ("fused_epochs", "early_stopping")]
    assert (fused.test_loss, fused.test_acc) == (plain.test_loss,
                                                 plain.test_acc)
    assert fused.gc_epoch_seconds == [] and fused.gc_fused_seconds > 0
    assert len(plain.gc_epoch_seconds) == 4 and plain.gc_fused_seconds is None
    assert len(stopped.gc_epoch_seconds) == 4
    assert stopped.test_loss == plain.test_loss


@pytest.mark.parametrize("setup,layer,method,extra", [
    ("Gc_train_2_Gs_train", "GCNConv", "GD", {}),
    ("Gc_train_2_Gs_train", "GCNConv", "MB", {}),
    ("Gs_train_2_Gs_infer", "GATConv", "GD", {"eval_chunk": 4}),
    ("Gs_train_2_Gs_infer", "GATConv", "MB", {"eval_chunk": 4}),
    ("Gc_train_2_Gs_infer", "GCNConv", "GD", {"fused_epochs": True})])
def test_run_node_task_bucketed_matches_jax(setup, layer, method, extra):
    """``run_node_task`` of both packages on the 4-bucket partition: GD over
    every bucket, MB bucket by bucket, the chunked eval, the fused Gc."""
    part, jpart = bucketed("extra_node", 0.9)
    kw = dict(layer_name=layer, hidden=HIDDEN, num_layers=2,
              out_dim=CLASSES, exp_setup=setup, epochs1=2, epochs2=2,
              gradient_method=method, batch_size=4, runs=1, seed=0, **extra)
    got, ref = run_pair(kw, part, jpart)
    assert_close(got.runs[0].test_loss, ref.runs[0].test_loss, 1e-4)
    assert_close(got.runs[0].test_acc, ref.runs[0].test_acc, 1e-4)


def _trained_gcn(jpart):
    jm = JaxNodeModel(layer_name="GCNConv", hidden=HIDDEN, num_layers=2,
                      out_dim=CLASSES)
    state = jax_steps.create_state(jm, jax.random.PRNGKey(3),
                                   jpart.subgraphs[0].subgraph(0).x,
                                   jpart.subgraphs[0].subgraph(0))
    for i in range(20):
        state, _ = jax_steps.gs_train_step_gd_multi(
            state, tuple(jpart.subgraphs), jax.random.PRNGKey(i),
            "classification")
    return jm, state.params


def test_node_inference_benchmark_bucketed_matches_jax():
    """The same sampled nodes, found at the same (bucket, position), give
    the same accuracy and loss; every sampled bucket is timed."""
    part, jpart = bucketed("extra_node", 0.9)
    _, _, _, y, _, _, te = node_data()
    jm, params = _trained_gcn(jpart)
    model = NodeModel("GCNConv", FEAT, HIDDEN, 2, CLASSES)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    n = 40
    nodes = inference._sample_nodes(te, n, 0)
    np.testing.assert_array_equal(nodes, jax_inference._sample_nodes(te, n,
                                                                     0))
    where = part.subgraph_index[part.parent[nodes]]
    np.testing.assert_array_equal(
        where, jpart.subgraph_index[jpart.parent[nodes]])
    assert len(np.unique(where[:, 0])) >= 2
    rep = inference.node_inference_benchmark(
        model, part.subgraphs, part.parent, te, y, num_samples=n, seed=0,
        subgraph_index=part.subgraph_index)
    jrep = jax_inference.node_inference_benchmark(
        jm, params, tuple(jpart.subgraphs), jpart.parent, te, y,
        num_samples=n, seed=0, subgraph_index=jpart.subgraph_index)
    assert rep.num_test_samples == jrep.num_test_samples == n
    assert rep.acc == jrep.acc and rep.acc > 0.5
    assert_close(rep.avg_loss, jrep.avg_loss, 1e-5)
    assert rep.avg_inf_time > 0 and rep.avg_inf_time_device > 0


def test_node_inference_benchmark_needs_the_index_for_buckets():
    part, _ = bucketed()
    _, _, _, y, _, _, te = node_data()
    model = NodeModel("GCNConv", FEAT, HIDDEN, 2, CLASSES)
    with pytest.raises(ValueError, match="subgraph_index"):
        inference.node_inference_benchmark(model, part.subgraphs,
                                           part.parent, te, y)
    # one bucket needs none
    single = coarsen_and_partition(*node_data()[:4], mode="extra_node",
                                   num_classes=CLASSES, test_mask=te)
    rep = inference.node_inference_benchmark(
        model, single.subgraphs, single.parent, te, y, num_samples=4)
    assert rep.num_test_samples == 4


def test_cli_train_then_infer_bucketed_on_npz_toy(toy):
    """``train`` with every new flag and ``infer`` on the bucketed
    partition: rows under the JAX package's headers, the partition computed
    once, the resume checkpoint left after the session."""
    common = ["--dataset", "toy", "--data_root", str(toy / "dataset"),
              "--hidden", "16", "--experiment", "random", "--device", "cpu",
              "--extra_node", "--bucket_sizes"]
    assert main(["train", "--runs", "2", "--epochs1", "15", "--epochs2",
                 "10", "--exp_setup", "Gc_train_2_Gs_train",
                 "--fused_epochs", "--eval_chunk", "8",
                 "--checkpoint_every", "4", *common]) == 0
    assert main(["train", "--runs", "1", "--epochs1", "3", "--epochs2",
                 "3", "--exp_setup", "Gs_train_2_Gs_infer",
                 "--gradient_method", "MB", "--batch_size", "8",
                 "--max_buckets", "1", *common]) == 0
    header, rows = _rows(toy / "results" / "toy.csv")
    assert header == jax_results.TRAIN_NODE_CLS_HEADER and len(rows) == 2
    assert float(rows[0]["best_acc"]) > 0.5
    saved = toy / "dataset" / "toy" / "saved" / "fitgnn_tpu_torch"
    assert len(list(saved.iterdir())) == 2      # max_buckets keys apart
    assert (toy / "save" / "node_cls" / "out" / "resume" /
            "state.pt").exists()
    assert main(["train", "--runs", "2", "--epochs1", "15", "--epochs2",
                 "10", "--exp_setup", "Gc_train_2_Gs_train",
                 "--fused_epochs", "--eval_chunk", "8",
                 "--checkpoint_every", "4", "--resume", *common]) == 0
    _, rows = _rows(toy / "results" / "toy.csv")
    assert rows[2]["best_acc"] == rows[0]["best_acc"]    # taken as saved
    assert main(["train", "--runs", "2", "--epochs1", "15", "--epochs2",
                 "10", "--exp_setup", "Gc_train_2_Gs_train", *common]) == 0
    assert main(["infer", "--num_test_samples", "32", *common]) == 0
    header, rows = _rows(toy / "inference_results" / "node_cls.csv")
    assert header == jax_results.INFERENCE_HEADER
    row = rows[-1]
    assert row["extra_nodes"] == "True" and row["num_test_samples"] == "32"
    assert float(row["avg_inf_time_device"]) > 0
    assert float(row["acc"]) > 0.5
    assert len(list(saved.iterdir())) == 2      # infer took the cache


def test_cli_unbucketed_partition_key_unchanged(toy):
    """The new key entries take the flags' values, which for an unbucketed
    run are the fixed ones of before: cached partitions stay valid."""
    from fitgnn_tpu_torch.cli import main as cli
    from fitgnn_tpu_torch.data.datasets import load_node_dataset
    from fitgnn_tpu_torch.utils.cache import ARTIFACT_KIND, content_key
    args = cli.arg_correction(cli.build_parser().parse_args(
        ["train", "--dataset", "toy", "--data_root", str(toy / "dataset"),
         "--experiment", "random", "--device", "cpu"]))
    ds = load_node_dataset("toy", str(toy / "dataset"))
    masks = cli._splits(args, ds, ds.num_classes)
    cli._partition(args, ds, *masks, ds.num_classes)

    def arr(m):
        return np.asarray(m, dtype=np.uint8)

    key = content_key(
        {"x": ds.x[:1000], "senders": ds.senders, "receivers": ds.receivers,
         "y": np.asarray(ds.y)[:1000], "train_mask": arr(masks[0]),
         "val_mask": arr(masks[1]), "test_mask": arr(masks[2])},
        {"ratio": 0.5, "method": "variation_neighborhoods", "mode": "plain",
         "task": "node_cls", "seed": 0, "bucket": False, "max_buckets": 0,
         "artifact": ARTIFACT_KIND})
    saved = toy / "dataset" / "toy" / "saved" / ARTIFACT_KIND
    assert [p.name for p in saved.iterdir()] == [f"{key}.pkl"]


def test_bucketed_partition_caches_as_a_tuple(tmp_path):
    from fitgnn_tpu_torch.utils.cache import ArtifactCache
    part, jpart = bucketed()
    cache = ArtifactCache(str(tmp_path))
    cache.save("k", part)
    back = cache.load("k")
    assert isinstance(back.subgraphs, tuple)
    assert_batches_equal(back.subgraphs, jpart.subgraphs)
    np.testing.assert_array_equal(back.subgraph_index, jpart.subgraph_index)
    back = dataclasses.replace(back)
    assert back.subgraph_index.dtype == np.int64
