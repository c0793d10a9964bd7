"""The port's graph-level data and model against the JAX package, on the
CPU: the synthetic sets, the splits, per-graph coarsening in the three
modes, the Gc/Gs collation (one batch and shared-pad chunks),
``GraphModel``'s two views for every layer on both aggregation branches,
and the max pool's gradient at ties.

The same numpy inputs go through both packages, with the JAX package's
parameters loaded into the port through ``params_from_flax``.  Data and
collation are compared exactly; forwards and sums within rtol 1e-5 and
atol 1e-5·max|ref| (f32 sums in another order); gradients within rtol
1e-4 and atol 1e-5·max|ref|.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from fitgnn_tpu.data import graph_level as jax_gl
from fitgnn_tpu.data import synthetic as jax_synthetic
from fitgnn_tpu.data.splits import splits_graph_level as jax_splits
from fitgnn_tpu.models.models import GraphModel as JaxGraphModel
from fitgnn_tpu.train import graph_loop as jax_loop
from fitgnn_tpu.utils.results import TRAIN_GRAPH_HEADER as JAX_GRAPH_HEADER

from fitgnn_tpu_torch.data import graph_level as gl
from fitgnn_tpu_torch.data import synthetic
from fitgnn_tpu_torch.data.splits import splits_graph_level
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import GraphModel
from fitgnn_tpu_torch.ops.spmm import DENSE_SPMM_MAX_N
from fitgnn_tpu_torch.train import graph_loop as loop
from fitgnn_tpu_torch.utils.results import TRAIN_GRAPH_HEADER

torch.set_num_threads(1)

HIDDEN = 16
MODES = ("plain", "extra_node", "cluster_node")
LAYERS = ("GCNConv", "GATConv", "SAGEConv", "GINConv")


def close(got, ref, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-5 * scale)


def exact(got, ref):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(ref))


@functools.lru_cache(maxsize=None)
def dataset(big=False, regression=False):
    """``random_graph_dataset``: 24 graphs of 10–30 nodes, or 80 of 20–40
    (whose train split collates above ``DENSE_SPMM_MAX_N`` coarse nodes);
    regression targets are the edge density."""
    kw = dict(num_graphs=80, min_nodes=20, max_nodes=40) if big \
        else dict(num_graphs=24)
    graphs, labels = synthetic.random_graph_dataset(seed=3, **kw)
    if regression:
        labels = np.array([len(s) / x.shape[0] for x, s, _ in graphs],
                          dtype=np.float32)
    return graphs, labels


@functools.lru_cache(maxsize=None)
def samples(mode="plain", big=False, regression=False):
    """Both packages' samples of ``dataset``."""
    graphs, y = dataset(big, regression)
    return tuple(
        [prep(x, s, r, y_, reduction=0.5, mode=mode)
         for (x, s, r), y_ in zip(graphs, y)]
        for prep in (gl.prepare_graph_sample, jax_gl.prepare_graph_sample))


def train_split(mode="plain", big=False, regression=False):
    """Both packages' collated train splits."""
    ours, theirs = samples(mode, big, regression)
    tr, _, _ = splits_graph_level(len(ours), seed=0)
    return (gl.collate_graph_level([ours[i] for i in tr]),
            jax_gl.collate_graph_level([theirs[i] for i in tr]))


def assert_batches_equal(got, ref):
    for name in ("x", "senders", "receivers", "edge_weight", "n_node",
                 "n_edge"):
        exact(getattr(got.gc, name), getattr(ref.gc, name))
    for name in ("x", "senders", "receivers", "edge_weight", "n_node",
                 "n_edge", "consume_mask", "orig_idx"):
        exact(getattr(got.gs, name), getattr(ref.gs, name))
    exact(got.gc_graph_ids, ref.gc_graph_ids)
    exact(got.gs_graph_ids, ref.gs_graph_ids)
    exact(got.graph_mask, ref.graph_mask)
    exact(got.y, ref.y)
    assert got.num_graphs == ref.num_graphs
    assert got.gc.node_mask.dtype == torch.bool
    exact(got.gc.node_mask, ref.gc.node_mask)


def test_synthetic_sets_match_jax():
    for ours, theirs in ((synthetic.qm9_like_dataset(40, seed=2),
                          jax_synthetic.qm9_like_dataset(40, seed=2)),
                         (synthetic.random_graph_dataset(20, seed=2),
                          jax_synthetic.random_graph_dataset(20, seed=2))):
        for (x, s, r), (xj, sj, rj) in zip(ours[0], theirs[0]):
            exact(x, xj)
            exact(s, sj)
            exact(r, rj)
        for a, b in zip(ours[1:], theirs[1:]):
            exact(a, b)
            assert a.dtype == b.dtype
    for a, b in zip(splits_graph_level(37, seed=5), jax_splits(37, seed=5)):
        exact(a, b)
    assert TRAIN_GRAPH_HEADER == JAX_GRAPH_HEADER


@pytest.mark.parametrize("mode", MODES)
def test_prepare_graph_sample_matches_jax(mode):
    ours, theirs = samples(mode)
    for a, b in zip(ours, theirs):
        exact(a.coarse_x, b.coarse_x)
        exact(a.coarse_senders, b.coarse_senders)
        exact(a.coarse_receivers, b.coarse_receivers)
        exact(a.y, b.y)
        assert len(a.subgraphs) == len(b.subgraphs)
        for sa, sb in zip(a.subgraphs, b.subgraphs):
            for name in ("orig_idx", "consume", "x", "senders", "receivers"):
                exact(getattr(sa, name), getattr(sb, name))


@pytest.mark.parametrize("mode,big,regression", [
    ("plain", False, False), ("extra_node", False, True),
    ("cluster_node", False, False), ("extra_node", True, False)])
def test_collate_matches_jax(mode, big, regression):
    got, ref = train_split(mode, big, regression)
    assert_batches_equal(got, ref)
    assert (got.gc.num_nodes_padded > DENSE_SPMM_MAX_N) == big
    assert got.y.dtype == (torch.float32 if regression else torch.int64)


@pytest.mark.parametrize("batch_size", [5, 7])
def test_collate_batches_shared_pad_matches_jax(batch_size):
    ours, theirs = samples("extra_node")
    got = gl.collate_graph_level_batches(ours, batch_size)
    ref = jax_gl.collate_graph_level_batches(theirs, batch_size)
    assert len(got) == len(ref) == -(-len(ours) // batch_size)
    for g, r in zip(got, ref):
        assert_batches_equal(g, r)
        assert g.gc.x.shape == got[0].gc.x.shape
        assert g.gs.x.shape == got[0].gs.x.shape
    # the last chunk is short: its padding samples are masked out
    assert not got[-1].graph_mask.all()
    assert gl.compute_pad_targets([ours[:3], ours[3:9]]) == \
        gl._PadTargets(**vars(jax_gl.compute_pad_targets(
            [theirs[:3], theirs[3:9]])))
    one = gl.collate_graph_level_batches(ours, 0)
    assert len(one) == 1
    assert_batches_equal(one[0], jax_gl.collate_graph_level(theirs))


def jax_model(layer, classify, out_dim, ref_batch, seed=0):
    m = JaxGraphModel(layer_name=layer, hidden=HIDDEN, num_layers=2,
                      out_dim=out_dim, classify=classify)
    params = m.init(jax.random.PRNGKey(seed), ref_batch.gc.x, ref_batch.gc,
                    ref_batch.gc_graph_ids, ref_batch.num_graphs)
    return m, params


def port_model(layer, classify, out_dim, in_dim, params):
    m = GraphModel(layer, in_dim=in_dim, hidden=HIDDEN, num_layers=2,
                   out_dim=out_dim, classify=classify)
    m.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return m.eval()


def jax_forward(m, params, b, view, train=False, rng=None):
    kw = {"train": train}
    if train:
        kw["rngs"] = {"dropout": rng}
    if view == "gc":
        return m.apply(params, b.gc.x, b.gc, b.gc_graph_ids, b.num_graphs,
                       **kw)
    return m.apply(params, b.gs, b.gs_graph_ids, b.num_graphs,
                   method=JaxGraphModel.forward_subgraphs, **kw)


@pytest.mark.parametrize("big", [False, True], ids=["dense", "per_edge"])
@pytest.mark.parametrize("classify", [True, False], ids=["cls", "reg"])
@pytest.mark.parametrize("layer", LAYERS)
def test_graph_model_views_match_jax(layer, classify, big):
    got_b, ref_b = train_split("extra_node", big, not classify)
    out_dim = 2 if classify else 1
    jm, params = jax_model(layer, classify, out_dim, ref_b)
    m = port_model(layer, classify, out_dim, got_b.gc.x.shape[1], params)
    with torch.no_grad():
        for view in ("gc", "gs"):
            out = loop._forward(m, got_b, view)
            ref = jax_forward(jm, params, ref_b, view)
            assert out.shape == ref.shape == (got_b.num_graphs, out_dim)
            close(out, ref)


def jax_grads(jm, params, b, classify, view, prop=None):
    def loss_fn(p):
        out = jax_forward(jm, p, b, view)
        return jax_loop._graph_loss(out, b.y, classify, prop,
                                    jax_loop._mask_of(b))

    return jax.value_and_grad(loss_fn)(params)


def port_grads(m, b, classify, view, prop=None):
    m.zero_grad()
    out = loop._forward(m, b, view)
    loss = loop._graph_loss(out, b.y, classify, prop, loop._mask_of(b))
    loss.backward()
    return loss, {k: p.grad for k, p in m.named_parameters()}


def assert_grads_close(m, got, ref):
    ref_sd = params_from_flax(jax.tree_util.tree_map(np.asarray, ref))
    assert set(got) == set(ref_sd)
    for k in got:
        close(got[k], ref_sd[k].numpy(), rtol=1e-4)
    assert all(torch.isfinite(g).all() for g in got.values())


@pytest.mark.parametrize("view", ["gc", "gs"])
def test_max_pool_ties_split_gradient_as_jax(view):
    """Two isolated nodes with the same features tie in the max pool (in
    the Gc view and, as two singleton subgraphs, in the Gs view): the
    gradient splits between them as the JAX package's does."""
    graphs, _ = dataset()
    x, s, r = graphs[0]
    x = np.concatenate([x, np.repeat(x[:1] + 5.0, 2, axis=0)])
    samples_ = [prep(x, s, r, 1, reduction=0.5)
                for prep in (gl.prepare_graph_sample,
                             jax_gl.prepare_graph_sample)]
    got_b = gl.collate_graph_level([samples_[0]])
    ref_b = jax_gl.collate_graph_level([samples_[1]])
    jm, params = jax_model("GCNConv", True, 2, ref_b, seed=1)
    m = port_model("GCNConv", True, 2, got_b.gc.x.shape[1], params)
    h = m.convs(got_b.gc.x, got_b.gc)[:int(got_b.gc.n_node)]
    twins = np.where((samples_[0].coarse_x == x[-1]).all(1))[0]
    assert len(twins) == 2
    assert (h[twins[0]] == h[twins[1]]).all()
    assert (h[twins[0]] >= h.amax(0)).any()
    loss_ref, g_ref = jax_grads(jm, params, ref_b, True, view)
    loss, g = port_grads(m, got_b, True, view)
    close(loss, loss_ref)
    assert_grads_close(m, g, g_ref)


