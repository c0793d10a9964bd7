"""The port's ``run_graph_task`` against the JAX package's in each of the
four graph setups (and with ``--multi_prop``), and the port's own
classification runs beating chance, on the CPU.

For the comparison dropout is off on both sides (rate 0: the JAX
``ConvStack``'s ``nn.Dropout(0.0)`` is an identity; the test patches the
name ``fitgnn_tpu.models.models`` looks up) and the port starts from the
JAX package's initial parameters.  ``best_test_loss`` and
``best_test_acc`` agree within rtol 1e-4 and atol 1e-5·max(1, |ref|):
f32 sums in another order over a few epochs of Adam.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax

import fitgnn_tpu.models.models as jax_models
from fitgnn_tpu.data import graph_level as jax_gl
from fitgnn_tpu.train import graph_loop as jax_loop

from fitgnn_tpu_torch.data import graph_level as gl
from fitgnn_tpu_torch.data.splits import splits_graph_level
from fitgnn_tpu_torch.data.synthetic import random_graph_dataset
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import GraphModel
from fitgnn_tpu_torch.train import graph_loop as loop
from fitgnn_tpu_torch.train.graph_loop import (GRAPH_EXP_SETUPS,
                                               GraphTaskConfig,
                                               run_graph_task)

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def split_samples(mode="plain", num_graphs=40, seed=0, targets="label"):
    """Both packages' (train, val, test) sample lists of
    ``random_graph_dataset``; ``targets``: the class label, the edge
    density (regression) or (node count, edge density) for
    ``--multi_prop``."""
    graphs, labels = random_graph_dataset(num_graphs=num_graphs, seed=seed)
    if targets == "density":
        labels = np.array([len(s) / x.shape[0] for x, s, _ in graphs],
                          dtype=np.float32)
    elif targets == "multi":
        labels = np.array([[x.shape[0], len(s) / x.shape[0]]
                           for x, s, _ in graphs], dtype=np.float32)
    idx = splits_graph_level(num_graphs, seed=seed)
    return tuple(
        tuple([ss[i] for i in ix] for ix in idx)
        for ss in ([prep(x, s, r, y_, reduction=0.5, mode=mode)
                    for (x, s, r), y_ in zip(graphs, labels)]
                   for prep in (gl.prepare_graph_sample,
                                jax_gl.prepare_graph_sample)))


def run_pair(kw, mode="plain", targets="label", batch_size=0):
    """``run_graph_task`` of both packages on the same splits (in chunks
    of ``batch_size`` graphs when it is set)."""
    ours, theirs = split_samples(mode, targets=targets)
    bt_j, bv_j, be_j = (jax_gl.collate_graph_level_batches(s, batch_size)
                        for s in theirs)
    # run_graph_task's init: the second key of PRNGKey(seed)'s split
    jm = jax_models.GraphModel(
        layer_name=kw["layer_name"], hidden=kw["hidden"],
        num_layers=kw["num_layers"], out_dim=kw["out_dim"],
        classify=kw["classify"])
    _, init_rng = jax.random.split(jax.random.PRNGKey(kw["seed"]))
    b0 = bt_j[0]
    init = jm.init(init_rng, b0.gc.x, b0.gc, b0.gc_graph_ids, b0.num_graphs)
    with mock.patch.object(jax_models, "ConvStack", functools.partial(
            jax_models.ConvStack, dropout_rate=0.0)):
        ref = jax_loop.run_graph_task(jax_loop.GraphTaskConfig(**kw), bt_j,
                                      bv_j, be_j)

    class FromJax(GraphModel):
        def __init__(self, *a, **k):
            super().__init__(*a, dropout_rate=0.0, **k)

        def reset_parameters(self, generator=None):
            self.load_state_dict(params_from_flax(
                jax.tree_util.tree_map(np.asarray, init)))
            return self

    with mock.patch.object(loop, "GraphModel", FromJax):
        got = run_graph_task(GraphTaskConfig(**kw, device="cpu"),
                             *(gl.collate_graph_level_batches(s, batch_size)
                               for s in ours))
    return got, ref


def assert_result_close(got, ref):
    for a, b in ((got.best_test_loss, ref.best_test_loss),
                 (got.best_test_acc, ref.best_test_acc)):
        assert np.isfinite(a)
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * max(1.0, abs(b)))


@pytest.mark.parametrize("setup,layer,mode,batch_size", [
    ("Gc_train_2_Gc_infer", "GCNConv", "plain", 0),
    ("Gc_train_2_Gs_infer", "GATConv", "extra_node", 8),
    ("Gs_train_2_Gs_infer", "SAGEConv", "extra_node", 8),
    ("Gc_train_2_Gs_train", "GINConv", "cluster_node", 0)])
def test_run_graph_task_matches_jax(setup, layer, mode, batch_size):
    kw = dict(layer_name=layer, hidden=16, num_layers=2, out_dim=2,
              classify=True, exp_setup=setup, epochs1=3, epochs2=3,
              seed=0, batch_size=batch_size)
    got, ref = run_pair(kw, mode=mode, batch_size=batch_size)
    assert_result_close(got, ref)
    if "Gc" in setup:
        assert len(got.gc_epoch_seconds) == 3
    assert len(got.gs_epoch_seconds) == (3 if setup.endswith("Gs_train")
                                         or setup.startswith("Gs") else 0)


@pytest.mark.parametrize("targets,prop,setup,layer,lr,epochs1,seed", [
    ("density", None, "Gc_train_2_Gs_train", "GCNConv", 0.01, 3, 1),
    ("density", None, "Gc_train_2_Gs_infer", "GATConv", 0.1, 8, 0),
    ("multi", 1, "Gc_train_2_Gc_infer", "GCNConv", 0.01, 3, 1)],
    ids=["reg", "reg_handoff", "multi_prop"])
def test_run_graph_task_regression_matches_jax(targets, prop, setup, layer,
                                               lr, epochs1, seed):
    """``reg_handoff``: at lr 0.1 the val loss is not monotone over the 8
    Gc epochs, so the Gs view must get the best Gc parameters, not the
    last ones, to agree."""
    kw = dict(layer_name=layer, hidden=16, num_layers=2, out_dim=1,
              classify=False, exp_setup=setup, epochs1=epochs1, epochs2=2,
              lr=lr, prop=prop, seed=seed, batch_size=8)
    got, ref = run_pair(kw, mode="extra_node", targets=targets,
                        batch_size=8)
    assert_result_close(got, ref)


def test_run_graph_task_saves_best_and_rejects_setup(tmp_path):
    (bt, bv, be), _ = split_samples()
    cfg = GraphTaskConfig(hidden=16, out_dim=2, epochs1=2, device="cpu",
                          save_path=str(tmp_path / "model.pt"))
    run_graph_task(cfg, gl.collate_graph_level(bt),
                   gl.collate_graph_level(bv), gl.collate_graph_level(be))
    sd = torch.load(tmp_path / "model.pt", weights_only=True)
    assert set(sd) == set(GraphModel("GCNConv", 8, 16, 2, 2).state_dict())
    with pytest.raises(ValueError, match="exp_setup"):
        run_graph_task(GraphTaskConfig(exp_setup="Gc_train_2_Gs",
                                       device="cpu"), bt, bv, be)


@pytest.mark.parametrize("exp_setup", GRAPH_EXP_SETUPS)
def test_graph_classification_beats_chance(exp_setup):
    """Dropout on, as the JAX package's own test of the four setups."""
    (bt, bv, be), _ = split_samples(
        mode="extra_node" if "Gs" in exp_setup else "plain")
    cfg = GraphTaskConfig(hidden=32, num_layers=2, out_dim=2, classify=True,
                          exp_setup=exp_setup, epochs1=40, epochs2=40,
                          seed=0, device="cpu")
    res = run_graph_task(cfg, gl.collate_graph_level(bt),
                         gl.collate_graph_level(bv),
                         gl.collate_graph_level(be))
    assert res.best_test_acc > 0.6, (exp_setup, res)


def test_gat_graph_training_stays_finite_where_the_reference_turns_nan():
    """The JAX GATConv's dense branch takes the exp before masking (a fault
    of the reference, ROADMAP.md §3): at lr 0.3 its graph training turns
    the parameters NaN within 4 epochs here, while the port's, from the
    same initial parameters and on the same chunks, stay finite."""
    from fitgnn_tpu.train.steps import TrainState, adam_l2
    ours, theirs = split_samples("extra_node", targets="density")
    bt = gl.collate_graph_level_batches(ours[0], 8)
    bt_j = jax_gl.collate_graph_level_batches(theirs[0], 8)
    jm = jax_models.GraphModel(layer_name="GATConv", hidden=16, num_layers=2,
                               out_dim=1, classify=False)
    init = jm.init(jax.random.PRNGKey(0), bt_j[0].gc.x, bt_j[0].gc,
                   bt_j[0].gc_graph_ids, bt_j[0].num_graphs)
    m = GraphModel("GATConv", 8, 16, 2, 1, classify=False, dropout_rate=0.0)
    m.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, init)))
    opt = loop.adam_l2(m.parameters(), 0.3, 5e-4)
    with mock.patch.object(jax_models, "ConvStack", functools.partial(
            jax_models.ConvStack, dropout_rate=0.0)):
        jm = jax_models.GraphModel(layer_name="GATConv", hidden=16,
                                   num_layers=2, out_dim=1, classify=False)
        state = TrainState.create(apply_fn=jm.apply, params=init,
                                  tx=adam_l2(0.3, 5e-4))
        for epoch in range(4):
            for i, (b, b_j) in enumerate(zip(bt, bt_j)):
                state, _ = jax_loop.graph_train_step(
                    state, b_j, jax.random.PRNGKey(i), False, None, "gc")
                loop.graph_train_step(m, opt, b, None, False, None, "gc")
    leaves = jax.tree_util.tree_leaves(state.params)
    assert any(np.isnan(np.asarray(v)).any() for v in leaves)
    assert all(torch.isfinite(p).all() for p in m.parameters())
