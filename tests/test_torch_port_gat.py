"""The port's GAT path against the JAX package, on the CPU.

The same numpy inputs, made from seeds, go through the JAX function and
its counterpart in the port.  The JAX Pallas kernels (K4, K5, K3w) run in
interpret mode; the port's wrappers take their plain versions because the
tensors lie on the CPU.  Tolerances: values within rtol 1e-4 and atol
1e-5·max(1, max|ref|), gradients within rtol 1e-4 and atol
1e-4·max(1, max|ref|) (f32 sums and exps taken in another order);
``build_dyn_plan`` arrays are identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.graph.build import build_graph as jax_build_graph
from fitgnn_tpu.graph.optimize import \
    build_optimized_graph as jax_build_optimized_graph
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.models.layers import GATConv as JaxGATConv
from fitgnn_tpu.ops import segment as jax_segment
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.pallas.bsr_dynamic import build_dyn_plan as jax_plan
from fitgnn_tpu.ops.pallas.bsr_dynamic import bsr_spmm_dyn as jax_dyn
from fitgnn_tpu.ops.pallas.coo_segmm import \
    _segmm_weighted_bwd as jax_segmm_weighted_bwd
from fitgnn_tpu.ops.pallas.coo_segmm import \
    segmm_weighted_spmm as jax_segmm_weighted
from fitgnn_tpu.ops.sddmm import gather_concat_score as jax_gcs
from fitgnn_tpu.ops.tile_gat import tile_gat_attention as jax_tile_gat

from fitgnn_tpu_torch.graph.build import build_graph
from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.layers import GATConv
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.ops import segment
from fitgnn_tpu_torch.ops.bsr_dynamic import (build_dyn_plan, bsr_spmm_dyn,
                                              dyn_grad_blocks, dyn_tiles,
                                              dyn_tiles_t)
from fitgnn_tpu_torch.ops.coo_segmm import (segmm_weighted_raw,
                                            segmm_weighted_spmm)
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
from fitgnn_tpu_torch.ops.sddmm import gather_concat_score
from fitgnn_tpu_torch.ops.tile_gat import tile_gat_attention

torch.set_num_threads(1)


def close(got, ref, grad=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=(1e-4 if grad else 1e-5) * scale)


def t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def community_graph(rng, n, feat, deg=10, block=128, internal=0.85):
    e = n * deg
    r = rng.integers(0, n, e)
    s_in = np.minimum((r // block) * block + rng.integers(0, block, e), n - 1)
    s = np.where(rng.random(e) < internal, s_in, rng.integers(0, n, e))
    keep = s != r
    perm = rng.permutation(n)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    return x, perm[s[keep]], perm[r[keep]]


def _tiles(seed=0, nb=5):
    """A sorted tile list covering every block row, whose block column 3
    is never used: the transpose plan needs a filler there."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.concatenate([np.arange(nb), rng.integers(0, nb, 6)]))
    cols = rng.permutation(np.resize([0, 1, 2, 4], len(rows)))
    return rows, cols, nb


def test_build_dyn_plan_matches_jax():
    rows, cols, nb = _tiles()
    pt, pj = build_dyn_plan(rows, cols, nb), jax_plan(rows, cols, nb)
    for name in ("t_sel", "t_scale", "t_rows", "t_cols"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name)),
                                      err_msg=name)
    assert pt.t_scale.numpy().tolist().count(0) == 1      # column 3
    for splits, r in ((pt.t_row_splits, pt.t_rows), (pt.row_splits, rows)):
        np.testing.assert_array_equal(
            splits.numpy(), np.searchsorted(np.asarray(r), np.arange(nb + 1)))


@pytest.mark.parametrize("feat", [16, 128])
def test_bsr_spmm_dyn_matches_jax(feat):
    rows, cols, nb = _tiles(seed=feat)
    rng = np.random.default_rng(feat + 1)
    blocks = rng.standard_normal((len(rows), 128, 128)).astype(np.float32)
    x = rng.standard_normal((nb * 128, feat)).astype(np.float32)
    tgt = rng.standard_normal((nb * 128, feat)).astype(np.float32)
    rj, cj = jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32)
    plan_j = jax_plan(rows, cols, nb)

    def loss_j(b, xx):
        out = jax_dyn(rj, cj, plan_j, b, xx)
        return jnp.sum((out - tgt) ** 2), out

    (lj, out_j), (db_j, dx_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(jnp.asarray(blocks),
                                              jnp.asarray(x))
    plan = build_dyn_plan(rows, cols, nb)
    bt, xt = t(blocks, True), t(x, True)
    out = bsr_spmm_dyn(t(rows.astype(np.int32)), t(cols.astype(np.int32)),
                       plan, bt, xt)
    ((out - t(tgt)) ** 2).sum().backward()
    close(out, out_j)
    close(bt.grad, db_j, grad=True)
    close(xt.grad, dx_j, grad=True)
    # the uncovered column block gets no gradient; no kernel ran
    assert not xt.grad[3 * 128:4 * 128].any()
    assert dyn_tiles.launches == dyn_tiles_t.launches == 0
    assert dyn_grad_blocks.launches == 0


def _straggler_hybrid(seed, n=512, e=900):
    """Straggler-only att_unit operators of both packages; a few edges
    carry static weight 0 (padding-like) and row block 2 receives none."""
    rng = np.random.default_rng(seed)
    r = np.sort(rng.integers(0, n, e))
    r = r[r // 128 != 2]
    s = rng.integers(0, n, len(r))
    w = (rng.random(len(r)) > 0.05).astype(np.float32)
    kw = dict(min_block_edges=10 ** 9, use_segmm=True, semantics="att_unit")
    return (build_hybrid(s, r, w, n, **kw), jax_build_hybrid(s, r, w, n, **kw),
            rng)


@pytest.mark.parametrize("feat", [40, 64])
def test_segmm_weighted_spmm_matches_jax(feat):
    ht, hj, rng = _straggler_hybrid(feat)
    e = ht.num_coo_edges
    w = rng.random(e).astype(np.float32)
    x = rng.standard_normal((ht.num_nodes, feat)).astype(np.float32)
    tgt = rng.standard_normal((ht.num_nodes, feat)).astype(np.float32)

    def loss_j(ww, xx):
        out = jax_segmm_weighted(hj.segmm, hj.t_segmm, hj.senders,
                                 hj.receivers, ww, xx)
        return jnp.sum((out - tgt) ** 2), out

    (_, out_j), (dw_j, dx_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(jnp.asarray(w), jnp.asarray(x))
    wt, xt = t(w, True), t(x, True)
    out = segmm_weighted_spmm(ht.segmm, ht.t_segmm, ht.senders, ht.receivers,
                              ht.t_edge_perm, wt, xt)
    ((out - t(tgt)) ** 2).sum().backward()
    close(out, out_j)
    close(wt.grad, dw_j, grad=True)
    close(xt.grad, dx_j, grad=True)
    assert not out[2 * 128:3 * 128].any()
    assert segmm_weighted_raw.launches == 0


@pytest.mark.parametrize("feat", [40, 64, 512])
def test_segmm_weighted_raw_perm_matches_jax_dx(feat):
    """K3w's dx form: one launch on the transpose CSR with the permutation
    passed (``w_edge[t_edge_perm]`` formed in the launch), against the JAX
    ``_segmm_weighted_bwd``'s dx (its Pallas kernel in interpret mode)."""
    ht, hj, rng = _straggler_hybrid(feat + 10)
    w = rng.random(ht.num_coo_edges).astype(np.float32)
    x = rng.standard_normal((ht.num_nodes, feat)).astype(np.float32)
    g = rng.standard_normal((ht.num_nodes, feat)).astype(np.float32)
    res = (hj.segmm, hj.t_segmm, hj.senders, hj.receivers, jnp.asarray(w),
           jnp.asarray(x))
    dx_j = jax_segmm_weighted_bwd(res, jnp.asarray(g))[5]
    dx = segmm_weighted_raw(ht.t_segmm, t(w), t(g), ht.t_edge_perm)
    close(dx, dx_j, grad=True)
    assert segmm_weighted_raw.launches == 0


@pytest.mark.parametrize("feat", [32, 96])
def test_tile_gat_attention_matches_jax(feat):
    """f ≤ 64 takes K3w for the straggler numerator, f > 64 the
    den-column scatter; nodes 100-119 have no edge at all."""
    rng = np.random.default_rng(feat)
    n, e = 512, 5000
    r = rng.integers(0, n, e)
    s = np.where(rng.random(e) < 0.85,
                 (r // 128) * 128 + rng.integers(0, 128, e),
                 rng.integers(0, n, e))
    keep = ((r < 100) | (r >= 120)) & ((s < 100) | (s >= 120))
    order = np.argsort(r[keep], kind="stable")
    s, r = s[keep][order], r[keep][order]
    w = np.ones(len(r), np.float32)
    kw = dict(min_block_edges=40, use_segmm=True, semantics="att_unit")
    ht, hj = build_hybrid(s, r, w, n, **kw), jax_build_hybrid(s, r, w, n, **kw)
    assert ht.bsr is not None and ht.num_coo_edges > 1
    assert ht.bsr.nnz_blocks == hj.bsr.nnz_blocks
    h = rng.standard_normal((n, feat)).astype(np.float32)
    a = (rng.standard_normal(feat) / np.sqrt(feat)).astype(np.float32)
    sd = (rng.standard_normal(n)).astype(np.float32)
    tgt = rng.standard_normal((n, feat)).astype(np.float32)

    def loss_j(hh, aa, ss):
        out = jax_tile_gat(hj, hh @ aa, ss, hh, 0.2, att_src=aa)
        return jnp.sum((out - tgt) ** 2), out

    (_, out_j), grads_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(h), jnp.asarray(a), jnp.asarray(sd))
    ht_, at, st = t(h, True), t(a, True), t(sd, True)
    out = tile_gat_attention(ht, ht_ @ at, st, ht_, 0.2, att_src=at)
    ((out - t(tgt)) ** 2).sum().backward()
    close(out, out_j)
    for got, ref in zip((ht_.grad, at.grad, st.grad), grads_j):
        assert torch.isfinite(got).all()
        close(got, ref, grad=True)


def _gat_params(rng, f_in, hidden):
    """A flax GATConv parameter tree of seeded values (no JAX init, whose
    forward would trace the interpret-mode kernels once more)."""
    def a(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"params": {"lin": {"kernel": a(f_in, hidden, scale=f_in ** -.5)},
                       "att_src": a(1, hidden, scale=hidden ** -.5),
                       "att_dst": a(1, hidden, scale=hidden ** -.5),
                       "bias": a(hidden, scale=0.1)}}


def _layer_sd(params):
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    return {"lin.weight": torch.tensor(p["lin"]["kernel"].T),
            "att_src": torch.tensor(p["att_src"]),
            "att_dst": torch.tensor(p["att_dst"]),
            "bias": torch.tensor(p["bias"])}


@pytest.mark.parametrize("branch,f_in,hidden", [
    ("dense", 16, 32), ("per_edge", 40, 24), ("hybrid", 96, 48)])
def test_gatconv_matches_jax(branch, f_in, hidden):
    """The three branches: dense (N_pad ≤ 512, aggregating on the narrow
    side of 16 → 32), per-edge, and the tile path on the att_unit hybrid
    (K3w at width 48).  The hybrid narrow side is held in the train-step
    tests."""
    rng = np.random.default_rng(f_in + hidden)
    n = 300 if branch == "dense" else 640
    x, s, r = community_graph(rng, n, f_in)
    if branch == "hybrid":
        gt, _ = build_optimized_graph(x, s, r, min_block_edges=80,
                                      layer_name="GATConv")
        gj, _ = jax_build_optimized_graph(x, s, r, min_block_edges=80,
                                          layer_name="GATConv")
        assert gt.aux.dyn_plan is not None and gt.aux.num_coo_edges > 1
    else:
        gt, gj = build_graph(x, s, r), jax_build_graph(x, s, r)
    layer = JaxGATConv(features=hidden)
    params = _gat_params(rng, f_in, hidden)
    tgt = rng.standard_normal((gt.num_nodes_padded, hidden)).astype(
        np.float32)

    def loss_j(p):
        out = layer.apply(p, gj.x, gj)
        return jnp.sum((out - tgt) ** 2), out

    (_, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    port = GATConv(f_in, hidden)
    port.load_state_dict(_layer_sd(params))
    out = port(gt.x, gt)
    ((out - t(tgt)) ** 2).sum().backward()
    close(out, out_j)
    ref = _layer_sd(grads_j)
    for name, p in port.named_parameters():
        close(p.grad, ref[name], grad=True)


@pytest.mark.parametrize("hybrid", [True, False])
def test_gat_node_model_eval_matches_jax(hybrid):
    rng = np.random.default_rng(7)
    x, s, r = community_graph(rng, 640, 16)
    if hybrid:
        gt, ot = build_optimized_graph(x, s, r, min_block_edges=80,
                                       layer_name="GATConv")
        gj, oj = jax_build_optimized_graph(x, s, r, min_block_edges=80,
                                           layer_name="GATConv")
        assert gt.aux.bsr is not None and gt.aux.num_coo_edges > 1
        np.testing.assert_array_equal(ot, oj)
    else:
        gt, gj = build_graph(x, s, r), jax_build_graph(x, s, r)
    jm = JaxNodeModel(layer_name="GATConv", hidden=32, num_layers=2,
                      out_dim=5)
    params = {"params": {
        "convs": {"GATConv_0": _gat_params(rng, 16, 32)["params"],
                  "GATConv_1": _gat_params(rng, 32, 32)["params"]},
        "head": {"kernel": rng.standard_normal((32, 5)).astype(np.float32),
                 "bias": np.zeros(5, np.float32)}}}
    ref = np.asarray(jm.apply(params, gj.x, gj))
    m = NodeModel("GATConv", 16, 32, 2, 5)
    m.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    with torch.inference_mode():
        out = m.eval()(gt.x, gt).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_gat_dense_branch_grads_stay_finite_under_large_scores():
    """A node pair without an edge may score far above its row's max; the
    exp is masked before it is taken, so the gradient stays finite (the
    JAX package's dense branch gives NaN here: ROADMAP.md §3)."""
    rng = np.random.default_rng(0)
    x, s, r = community_graph(rng, 200, 8, deg=3)
    g = build_graph(x, s[r < 150], r[r < 150])     # nodes ≥ 150: self loops
    layer = GATConv(8, 16)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.att_src.mul_(400.0)
    xt = g.x.clone().requires_grad_(True)
    layer(xt, g).sum().backward()
    assert torch.isfinite(xt.grad).all()
    for p in layer.parameters():
        assert torch.isfinite(p.grad).all()


def test_gat_init_is_seeded_and_flax_scaled():
    a = GATConv(64, 512)
    b = GATConv(64, 512)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for va, vb in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(va, vb)
    bound = (6 / (1 + 512)) ** 0.5                    # glorot, (1, 512)
    att = a.att_src.detach().abs()
    assert 0.9 * bound < float(att.max()) <= bound
    assert abs(float(a.lin.weight.detach().std()) - 64 ** -0.5) < 0.01
    assert not a.bias.any()


def test_segment_helpers_match_jax():
    rng = np.random.default_rng(12)
    e, n = 60, 9
    ids = np.sort(rng.integers(0, n - 1, e)).astype(np.int32)   # n-1 empty
    data = rng.standard_normal((e, 3)).astype(np.float32)
    logits = rng.standard_normal(e).astype(np.float32)
    mask = rng.random(e) > 0.2
    ti, tm = t(ids), t(mask)
    for fn, jfn in ((segment.segment_max, jax_segment.segment_max),
                    (segment.segment_mean, jax_segment.segment_mean)):
        for msk, jmsk in ((None, None), (tm, jnp.asarray(mask))):
            close(fn(t(data), ti, n, mask=msk),
                  jfn(jnp.asarray(data), jnp.asarray(ids), n, mask=jmsk))
    close(segment.segment_softmax(t(logits), ti, n, mask=tm),
          jax_segment.segment_softmax(jnp.asarray(logits), jnp.asarray(ids),
                                      n, mask=jnp.asarray(mask)))
    src = rng.standard_normal(n).astype(np.float32)
    dst = rng.standard_normal(n).astype(np.float32)
    s = rng.integers(0, n, e).astype(np.int32)
    close(gather_concat_score(t(s), ti, t(src), t(dst)),
          jax_gcs(jnp.asarray(s), jnp.asarray(ids), jnp.asarray(src),
                  jnp.asarray(dst)))


@pytest.mark.parametrize("env,kwargs", [
    ({}, dict(partials=True)),
    ({"FITGNN_GAT_FUSED_BWD": "1"}, {}),
    ({"FITGNN_GAT_SORTED_NUM": "1"}, {}),
    ({"FITGNN_GAT_SORTED_SRC": "1"}, {})])
def test_unported_tile_gat_options_raise(monkeypatch, env, kwargs):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ht, _, _ = _straggler_hybrid(1)
    v = torch.zeros(ht.num_nodes)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tile_gat_attention(ht, v, v, torch.zeros(ht.num_nodes, 4), 0.2,
                           **kwargs)
