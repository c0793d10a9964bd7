"""The port's SAGEConv and GINConv against the JAX package, on the CPU.

The same seeded numpy inputs go through both packages: each layer on the
hybrid operator (its ``mean_nonself`` or ``sum_nonself`` weights; the
port's wrappers take their plain versions because the tensors lie on the
CPU, the JAX Pallas kernels run in interpret mode), on the dense branch,
on the per-edge branch and on a stack of subgraphs against ``jax.vmap``,
on both sides of the narrow-side switch; the operators of both semantics
and the backward of the asymmetric ``mean_nonself`` operator on every
layout; ``params_from_flax``; one train step.  ``run_node_task``,
layer-0 pre-aggregation and the CLI are in
``tests/test_torch_port_preagg.py``.

Tolerances: forwards within rtol 1e-5 and atol 1e-6·max(1, max|ref|)
(GIN's unnormalised sums cancel under its ReLU to ~1e-6 of their terms);
gradients, train steps and losses within rtol 1e-4 and atol
1e-5·max(1, max|ref|) (f32 sums in another order); operator arrays
exactly.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fitgnn_tpu.train.steps as jax_steps
from fitgnn_tpu.graph.build import build_graph as jax_build_graph
from fitgnn_tpu.graph.container import Graph as JaxGraph
from fitgnn_tpu.graph.optimize import \
    build_optimized_graph as jax_build_optimized_graph
from fitgnn_tpu.graph.optimize import optimize_coarse as jax_optimize_coarse
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.models.layers import GINConv as JaxGINConv
from fitgnn_tpu.models.layers import SAGEConv as JaxSAGEConv
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.hybrid_spmm import hybrid_spmm as jax_hybrid_spmm
from fitgnn_tpu.train import losses as jax_losses

from fitgnn_tpu_torch.graph.build import build_graph
from fitgnn_tpu_torch.graph.container import Graph
from fitgnn_tpu_torch.graph.optimize import (_operator_weights,
                                             build_optimized_graph,
                                             optimize_coarse)
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.layers import GINConv, SAGEConv, make_layer
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid, hybrid_spmm
from fitgnn_tpu_torch.ops.spmm import DENSE_SPMM_MAX_N
from fitgnn_tpu_torch.train import steps

from test_torch_port_curriculum import partitions

torch.set_num_threads(1)

LAYERS = ("SAGEConv", "GINConv")
SEMANTICS = {"SAGEConv": "mean_nonself", "GINConv": "sum_nonself"}
PORT = {"SAGEConv": SAGEConv, "GINConv": GINConv}
JAX = {"SAGEConv": JaxSAGEConv, "GINConv": JaxGINConv}


def close(got, ref, grad=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=1e-4 if grad else 1e-5,
                               atol=(1e-5 if grad else 1e-6) * scale)


def community_graph(rng, n, feat, deg=10, block=128, internal=0.85,
                    isolated=0):
    """A community graph whose last ``isolated`` nodes have no edge (their
    SAGE mean is empty: ``lin_l`` gives them its bias alone)."""
    m = n - isolated
    e = m * deg
    r = rng.integers(0, m, e)
    s_in = np.minimum((r // block) * block + rng.integers(0, block, e), m - 1)
    s = np.where(rng.random(e) < internal, s_in, rng.integers(0, m, e))
    keep = s != r
    perm = np.concatenate([rng.permutation(m), np.arange(m, n)])
    x = rng.standard_normal((n, feat)).astype(np.float32)
    return x, perm[s[keep]], perm[r[keep]]


def layer_params(layer, params):
    """A flax layer's parameters as the port's layer state dict, through
    ``params_from_flax`` on a one-layer tree."""
    tree = {"convs": {f"{layer}_0": jax.tree_util.tree_map(
                np.asarray, params["params"])},
            "head": {"kernel": np.zeros((1, 1), np.float32),
                     "bias": np.zeros(1, np.float32)}}
    sd = params_from_flax(tree)
    return {k[len("convs.layers.0."):]: v for k, v in sd.items()
            if k.startswith("convs.layers.0.")}


def _stack(graphs):
    return Graph(*(None if f[0] is None else torch.stack(f)
                   for f in zip(*graphs)))


def _jax_stack(graphs):
    return JaxGraph(*(None if f[0] is None else jnp.stack(f)
                      for f in zip(*graphs)))


@functools.lru_cache(maxsize=None)
def branch_graphs(layer, branch):
    """(port graph, JAX graph) for one aggregation branch: ``hybrid`` (the
    layer's operator), ``dense`` (at most ``DENSE_SPMM_MAX_N`` padded
    nodes), ``per_edge`` (more), and stacks of 3 subgraphs on the dense
    and per-edge branches."""
    rng = np.random.default_rng(len(branch) + len(layer))
    feat = 16
    if branch == "hybrid":
        x, s, r = community_graph(rng, 640, feat)
        kw = dict(min_block_edges=80, layer_name=layer)
        gt, _ = build_optimized_graph(x, s, r, **kw)
        gj, _ = jax_build_optimized_graph(x, s, r, **kw)
        assert gt.aux.semantics == SEMANTICS[layer]
        assert gt.aux.bsr is not None and gt.aux.num_coo_edges > 1
        return gt, gj
    stacked = branch.startswith("stack")
    n = 300 if branch.endswith("dense") else 700
    pads = dict(node_pad_to=n + 8, edge_pad_to=1 << 14)
    pairs = []
    for _ in range(3 if stacked else 1):
        x, s, r = community_graph(rng, n, feat, deg=4, isolated=5)
        pairs.append((build_graph(x, s, r, **pads),
                      jax_build_graph(x, s, r, **pads)))
    gt, gj = pairs[0]
    if stacked:
        gt = _stack([p[0] for p in pairs])
        gj = _jax_stack([p[1] for p in pairs])
    assert (gt.num_nodes_padded <= DENSE_SPMM_MAX_N) == branch.endswith(
        "dense")
    return gt, gj


BRANCHES = ("hybrid", "dense", "per_edge", "stack_dense", "stack_per_edge")


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("hidden", [8, 32])
@pytest.mark.parametrize("layer", LAYERS)
def test_layer_matches_jax(layer, hidden, branch):
    """Forward and the gradient of every parameter (GIN's ``eps`` set to
    0.3 so that it weighs in) against ``jax.grad``; hidden 8 is the narrow
    side of the 16-wide input, hidden 32 the wide side."""
    gt, gj = branch_graphs(layer, branch)
    stacked = branch.startswith("stack")
    jl = JAX[layer](features=hidden)
    g0 = JaxGraph(*(None if f is None else f[0] for f in gj)) \
        if stacked else gj
    params = jl.init(jax.random.PRNGKey(1), g0.x, g0)
    if layer == "GINConv":
        params = {"params": {**params["params"], "eps": jnp.float32(0.3)}}
    tgt = np.random.default_rng(2).standard_normal(
        gt.x.shape[:-1] + (hidden,)).astype(np.float32)

    def apply(p):
        if stacked:
            return jax.vmap(lambda x, g: jl.apply(p, x, g))(gj.x, gj)
        return jl.apply(p, gj.x, gj)

    ref = apply(params)
    grads = jax.grad(lambda p: jnp.sum(apply(p) * tgt))(params)

    mod = PORT[layer](16, hidden)
    mod.load_state_dict(layer_params(layer, params))
    out = mod(gt.x, gt)
    close(out, ref)
    (out * torch.from_numpy(tgt)).sum().backward()
    ref_grads = layer_params(layer, grads)
    assert {k for k, _ in mod.named_parameters()} == set(ref_grads)
    for k, p in mod.named_parameters():
        close(p.grad, ref_grads[k].numpy(), grad=True)


def test_make_layer_and_init():
    """``make_layer`` builds all four layers; the init is flax's
    (lecun_normal kernels, zero biases, zero 0-dim eps)."""
    for name in ("GCNConv", "GATConv", *LAYERS):
        assert type(make_layer(name, 8, 16)).__name__ == name
    m = NodeModel("GINConv", 256, 512, 2, 40).reset_parameters(
        torch.Generator().manual_seed(0))
    gin = m.convs.layers[0]
    assert gin.eps.shape == () and float(gin.eps.detach()) == 0.0
    assert abs(float(gin.mlp_0.weight.std()) - (1 / 256) ** 0.5) < 0.003
    assert not gin.mlp_0.bias.any() and not gin.mlp_1.bias.any()
    m = NodeModel("SAGEConv", 256, 512, 2, 40).reset_parameters(
        torch.Generator().manual_seed(0))
    sage = m.convs.layers[1]
    assert sage.lin_r.bias is None and not sage.lin_l.bias.any()
    assert abs(float(sage.lin_r.weight.std()) - (1 / 512) ** 0.5) < 0.003


@pytest.mark.parametrize("layer", LAYERS)
def test_params_from_flax(layer):
    """A flax SAGE or GIN ``NodeModel`` tree onto the port's state dict:
    the keys and shapes of the port's model, kernels transposed, GIN's
    ``eps`` 0-dim."""
    rng = np.random.default_rng(3)
    x, s, r = community_graph(rng, 60, 6)
    gj = jax_build_graph(x, s, r)
    jm = JaxNodeModel(layer_name=layer, hidden=12, num_layers=3, out_dim=4)
    params = jm.init(jax.random.PRNGKey(0), gj.x, gj)
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    model = NodeModel(layer, 6, 12, 3, 4)
    assert {k: v.shape for k, v in sd.items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    p = params["params"]["convs"][f"{layer}_0"]
    if layer == "SAGEConv":
        np.testing.assert_array_equal(sd["convs.layers.0.lin_l.weight"],
                                      np.asarray(p["lin_l"]["kernel"]).T)
        assert "convs.layers.0.lin_r.bias" not in sd
    else:
        assert sd["convs.layers.0.eps"].shape == ()
        np.testing.assert_array_equal(sd["convs.layers.2.mlp_1.bias"],
                                      np.asarray(params["params"]["convs"][
                                          "GINConv_2"]["mlp_1"]["bias"]))
    with torch.no_grad():
        out = model.eval()(build_graph(x, s, r).x, build_graph(x, s, r))
    close(out, jm.apply(params, gj.x, gj))


# --- the operators --------------------------------------------------------

def _operator_arrays(h):
    arrays = {k: getattr(h, k) for k in (
        "senders", "receivers", "weights", "t_senders", "t_receivers",
        "t_weights", "t_edge_perm", "diag_blocks")}
    for name, b in (("bsr", h.bsr), ("bsrT", None if h.bsr is None
                                      else h.bsr.transpose)):
        if b is not None:
            for k in ("blocks", "rows", "cols", "row_splits"):
                arrays[f"{name}.{k}"] = getattr(b, k)
    return {k: np.asarray(v) for k, v in arrays.items() if v is not None}


OPT_INS = {"default": {}, "use_diag": dict(use_diag=True),
           "tile_group2": dict(tile_group=2)}


@pytest.mark.parametrize("opt_in", list(OPT_INS))
@pytest.mark.parametrize("layer", LAYERS)
def test_optimized_graph_matches_jax(layer, opt_in):
    """``build_optimized_graph`` under both semantics: every array of the
    graph and its operator equal to the JAX package's; the split counts
    edges (zero-weight self loops included), so it is GCN's."""
    rng = np.random.default_rng(4)
    x, s, r = community_graph(rng, 700, 8)
    kw = dict(min_block_edges=60, layer_name=layer, **OPT_INS[opt_in])
    gt, ot = build_optimized_graph(x, s, r, **kw)
    gj, oj = jax_build_optimized_graph(x, s, r, **kw)
    np.testing.assert_array_equal(ot, oj)
    assert gt.aux.semantics == gj.aux.semantics == SEMANTICS[layer]
    got, ref = _operator_arrays(gt.aux), _operator_arrays(gj.aux)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    gcn, _ = build_optimized_graph(x, s, r, **{**kw, "layer_name":
                                               "GCNConv"})
    assert gt.aux.num_coo_edges == gcn.aux.num_coo_edges
    if gt.aux.bsr is not None:
        assert torch.equal(gt.aux.bsr.rows, gcn.aux.bsr.rows)
        assert torch.equal(gt.aux.bsr.cols, gcn.aux.bsr.cols)


@pytest.mark.parametrize("layer", LAYERS)
def test_optimize_coarse_matches_jax(layer):
    part, jpart = partitions()
    ct = optimize_coarse(part.coarse, min_block_edges=4, layer_name=layer)
    cj = jax_optimize_coarse(jpart.coarse, min_block_edges=4,
                             layer_name=layer)
    assert ct.graph.aux.semantics == SEMANTICS[layer]
    for k in ("x", "senders", "receivers", "edge_weight"):
        np.testing.assert_array_equal(getattr(ct.graph, k).numpy(),
                                      np.asarray(getattr(cj.graph, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(ct.train_mask.numpy(),
                                  np.asarray(cj.train_mask))
    got, ref = _operator_arrays(ct.graph.aux), _operator_arrays(cj.graph.aux)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


LAYOUTS = {"default": {}, "use_diag": dict(use_diag=True),
           "tile_group2": dict(tile_group=2),
           "use_rowwalk": dict(use_rowwalk=True), "forward_only": {}}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mean_nonself_backward_matches_jax(layout):
    """The hybrid SpMM under SAGE's ``mean_nonself`` weights, whose matrix
    is not symmetric (``1/indeg[r]`` on edge r←s): forward and ``dx``
    against ``jax.vjp`` of the JAX ``hybrid_spmm`` and against float64
    dense ``A·x`` and ``Aᵀ·g``, on the default, ``use_diag``,
    ``tile_group=2`` and ``use_rowwalk`` layouts.  The forward-only
    operator (a BCSR without its transpose) has no backward in either
    package: its forward is held, and both refuse the gradient."""
    rng = np.random.default_rng(5)
    n, e = 768, 9000
    r = np.sort(rng.integers(0, n, e))
    s = np.where(rng.random(e) < 0.8, (r // 128) * 128
                 + rng.integers(0, 128, e), rng.integers(0, n, e))
    r = np.concatenate([r, np.arange(n)])            # GCN-style self loops
    s = np.concatenate([s, np.arange(n)])
    order = np.argsort(r, kind="stable")
    s, r = s[order], r[order]
    w = _operator_weights(s, r, np.ones(len(s), np.float32), n,
                          "mean_nonself")
    a = np.zeros((n, n))
    np.add.at(a, (r, s), w.astype(np.float64))
    assert not np.allclose(a, a.T)
    kw = dict(min_block_edges=40, use_segmm=True, semantics="mean_nonself",
              **LAYOUTS[layout])
    ht, hj = build_hybrid(s, r, w, n, **kw), jax_build_hybrid(s, r, w, n,
                                                              **kw)
    if layout == "forward_only":
        ht = dataclasses.replace(ht, bsr=dataclasses.replace(
            ht.bsr, transpose=None))
        hj = hj.replace(bsr=hj.bsr.replace(transpose=None))
    x = rng.standard_normal((n, 16)).astype(np.float32)
    g = rng.standard_normal((n, 16)).astype(np.float32)
    if layout == "forward_only":
        with torch.no_grad():
            close(hybrid_spmm(ht, torch.from_numpy(x)),
                  jax_hybrid_spmm(hj, jnp.asarray(x)))
        with pytest.raises(ValueError, match="with_transpose"):
            hybrid_spmm(ht, torch.tensor(x, requires_grad=True))
        with pytest.raises(AssertionError, match="with_transpose"):
            jax.vjp(lambda xx: jax_hybrid_spmm(hj, xx), jnp.asarray(x))[1](
                jnp.asarray(g))
        return
    out_j, vjp = jax.vjp(lambda xx: jax_hybrid_spmm(hj, xx), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    out = hybrid_spmm(ht, xt)
    out.backward(torch.from_numpy(g))
    close(out, out_j)
    close(xt.grad, dx_j, grad=True)
    close(out, a @ x)
    close(xt.grad, a.T @ g, grad=True)


# --- training -------------------------------------------------------------

@pytest.mark.parametrize("layer", LAYERS)
def test_gc_train_step_matches_jax(layer):
    """One ``gc_train_step`` on the layer's hybrid operator, dropout off:
    the loss, every gradient (GIN's 0-dim ``eps`` included) and the
    parameters after Adam with L2, which decays ``eps`` too."""
    rng = np.random.default_rng(6)
    x, s, r = community_graph(rng, 640, 16)
    y = rng.integers(0, 4, 640)
    mask = rng.random(640) < 0.5
    kw = dict(y=y, train_mask=mask, min_block_edges=80, layer_name=layer)
    gt, _ = build_optimized_graph(x, s, r, **kw)
    gj, _ = jax_build_optimized_graph(x, s, r, **kw)
    jm = JaxNodeModel(layer_name=layer, hidden=32, num_layers=2, out_dim=4,
                      dropout_rate=0.0)
    state = jax_steps.create_state(jm, jax.random.PRNGKey(2), gj.x, gj)
    if layer == "GINConv":
        p = state.params["params"]
        p = {"params": {**p, "convs": {**p["convs"], "GINConv_1": {
            **p["convs"]["GINConv_1"], "eps": jnp.float32(0.2)}}}}
        state = state.replace(params=p, opt_state=state.tx.init(p))

    def loss_j(p):
        out = jm.apply(p, gj.x, gj)
        return jax_losses.masked_nll(out, gj.y, gj.train_mask)

    loss_ref, grads = jax.value_and_grad(loss_j)(state.params)
    new, _ = jax_steps.gc_train_step(state, gj, gj.y, gj.train_mask,
                                     jax.random.PRNGKey(0), "classification")
    model = NodeModel(layer, 16, 32, 2, 4, dropout_rate=0.0)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, state.params)))
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    loss = steps.gc_train_step(model, opt, gt, gt.y, gt.train_mask, None,
                               "classification")
    close(loss, loss_ref, grad=True)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in model.named_parameters():
        close(p.grad, ref[name], grad=True)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, new.params))
    for name, v in model.state_dict().items():
        close(v, ref[name], grad=True)
    if layer == "GINConv":
        assert model.convs.layers[1].eps.shape == ()
        assert float(model.convs.layers[1].eps) != 0.2
