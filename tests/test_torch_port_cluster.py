"""The cluster collapse of the stragglers (``build_hybrid(cluster_agg=…,
cluster_att=…)`` and their ``_exact`` splits) against the JAX package, on
the CPU.

The same seeded numpy inputs go through both packages: the operator's
arrays (the straggler lists that stay, the (N, C) table, its type, the
scales and the member mask) for exact k in {0, some, all}; the static
term through ``hybrid_spmm`` for GCN, SAGE and GIN weights on every tile
layout, value and gradient; the padding rows' exclusion; the attention
collapse through ``tile_gat_attention`` under each switch set, value and
gradient, with the exact max's fold of the summary rows; the guards;
``build_optimized_graph`` and ``optimize_coarse`` with a collapse; one
layer of each conv with converted weights.  The JAX Pallas kernels run in
interpret mode; the port's wrappers take their plain versions because the
tensors lie on the CPU.

Tolerances: arrays exactly; values and gradients on f32 tables within
rtol 1e-5 and atol 1e-5·max|ref| (f32 sums in another order); on bf16
tables atol 8e-3·max|ref| (one bf16 ulp of a summary can flip with the
order of its f32 sum), and 2e-2·max|ref| on the einsum layout's bf16
tiles (that layout's own rounding, as ``test_torch_port_bf16.py`` holds
it); attention gradients within rtol 1e-4 and atol 1e-4·max(1, max|ref|)
(exps and f32 sums in another order, as ``test_torch_port_fused.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.data.synthetic import sbm_graph
from fitgnn_tpu.graph.optimize import \
    build_optimized_graph as jax_build_optimized_graph
from fitgnn_tpu.graph.optimize import optimize_coarse as jax_optimize_coarse
from fitgnn_tpu.models import layers as jax_layers
from fitgnn_tpu.ops import tile_gat as jax_tile_gat_mod
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.hybrid_spmm import hybrid_spmm as jax_hybrid_spmm

from fitgnn_tpu_torch.graph.optimize import (_operator_weights,
                                             build_optimized_graph,
                                             optimize_coarse)
from fitgnn_tpu_torch.models import layers
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid, hybrid_spmm
from fitgnn_tpu_torch.ops.tile_gat import tile_gat_attention

from test_torch_port_curriculum import _rows, partitions, toy  # noqa: F401
from test_torch_port_fused import SWITCHES, switch
from test_torch_port_sage_gin import community_graph, layer_params

torch.set_num_threads(1)

BF16 = torch.bfloat16
SLOPE = 0.2
F32_TOL = 1e-5
BF16_TABLE_TOL = 8e-3
EINSUM_BF16_TOL = 2e-2


def close(got, ref, tol=F32_TOL, rtol=F32_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=tol * float(np.abs(ref).max(initial=0)))


def close_att(got, ref, grad=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=(1e-4 if grad else 1e-5) * scale)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def coo(seed, n=768, e=6000, real=None, internal=0.7, pad_edges=4):
    """Receiver-sorted edges among the first ``real`` nodes, most inside
    their 128-block, weights in (0.1, 1.1], plus ``pad_edges`` weight-0
    edges (padding: never ranked, never collapsed)."""
    rng = np.random.default_rng(seed)
    nr = n if real is None else real
    r = rng.integers(0, nr, e)
    s = np.where(rng.random(e) < internal,
                 np.minimum((r // 128) * 128 + rng.integers(0, 128, e),
                            nr - 1), rng.integers(0, nr, e))
    w = (rng.random(e) + 0.1).astype(np.float32)
    s = np.concatenate([s, np.full(pad_edges, n - 1)])
    r = np.concatenate([r, np.full(pad_edges, n - 1)])
    w = np.concatenate([w, np.zeros(pad_edges, np.float32)])
    order = np.argsort(r, kind="stable")
    return s[order].astype(np.int64), r[order].astype(np.int64), w[order]


def both(s, r, w, n, **kw):
    """The operator from both packages (the port's tile type torch's, the
    JAX package's jnp's)."""
    dt = kw.pop("tile_dtype", None)
    ht = build_hybrid(s, r, w, n, tile_dtype=dt, **kw)
    hj = jax_build_hybrid(s, r, w, n, tile_dtype=None if dt is None
                          else jnp.bfloat16, **kw)
    return ht, hj


CLUSTER_ARRAYS = ("senders", "receivers", "weights", "t_senders",
                  "t_receivers", "t_weights", "t_edge_perm", "cluster_count",
                  "cluster_scale", "cluster_member")


def assert_same_operator(ht, hj):
    assert ht.cluster_size == hj.cluster_size
    assert ht.num_coo_edges == hj.num_coo_edges
    assert str(ht.cluster_count.dtype).split(".")[-1] == str(
        hj.cluster_count.dtype)
    for k in CLUSTER_ARRAYS:
        np.testing.assert_array_equal(f32(getattr(ht, k)),
                                      f32(getattr(hj, k)), err_msg=k)
    if hj.bsr is not None:
        np.testing.assert_array_equal(ht.bsr.rows.numpy(),
                                      np.asarray(hj.bsr.rows))
        np.testing.assert_array_equal(ht.bsr.cols.numpy(),
                                      np.asarray(hj.bsr.cols))


# ---- the operator's arrays --------------------------------------------------

# (table) → build_hybrid's collapse arguments, by exact k
TABLES = {"agg_f32": lambda k: dict(cluster_agg=128, cluster_agg_exact=k),
          "agg_bf16": lambda k: dict(cluster_agg=256, cluster_agg_exact=k,
                                     tile_dtype=BF16),
          "att": lambda k: dict(cluster_att=128, cluster_att_exact=k,
                                semantics="att_unit")}


@pytest.mark.parametrize("exact", [0, 9, 10 ** 6])
@pytest.mark.parametrize("table", list(TABLES))
def test_build_hybrid_arrays_match_jax(table, exact):
    """Exact k of 0 (everything collapses), 9 (the top senders keep the
    per-edge path) and more than there are senders (nothing collapses: the
    table is zero); 700 real rows of 768."""
    s, r, w = coo(1, real=700)
    kw = TABLES[table](exact)
    if table == "att":
        w = (w > 0).astype(np.float32)
    ht, hj = both(s, r, w, 768, min_block_edges=120, use_segmm=True,
                  real_nodes=700, **kw)
    assert_same_operator(ht, hj)
    want = {"agg_f32": torch.float32, "agg_bf16": BF16, "att": BF16}
    assert ht.cluster_count.dtype == want[table]
    assert float(ht.cluster_member.sum()) == 700
    n_real = int((f32(ht.weights) > 0).sum())
    if exact == 0:
        # every real straggler collapsed: the one inert edge is left
        assert ht.num_coo_edges == 1 and n_real == 0
        assert float(ht.cluster_count.float().sum()) > 0
    elif exact == 9:
        assert 0 < n_real < int(((w > 0) & ~_dense(s, r, 768, 120)).sum())
    else:
        assert float(ht.cluster_count.float().abs().sum()) == 0


def _dense(s, r, n, t):
    nb = n // 128
    tile = (r // 128) * nb + s // 128
    _, inv, cnt = np.unique(tile, return_inverse=True, return_counts=True)
    return cnt[inv] >= t


def test_attention_table_widens_to_f32_past_256():
    """Integer counts are exact in bf16 up to 256: a receiver with 300
    collapsed in-edges from one cluster gets an f32 table, as in the JAX
    package."""
    n = 512
    s = np.concatenate([np.arange(300) % 128, np.arange(40)])
    r = np.concatenate([np.full(300, 400), np.arange(40) + 200])
    order = np.argsort(r, kind="stable")
    s, r = s[order], r[order]
    w = np.ones(len(s), np.float32)
    ht, hj = both(s, r, w, n, min_block_edges=10 ** 6, cluster_att=128,
                  semantics="att_unit")
    assert ht.cluster_count.dtype == torch.float32
    assert_same_operator(ht, hj)
    assert float(ht.cluster_count[400, 0]) == 300


def test_static_table_holds_summed_weights():
    """Duplicate edges sum their weights (0.1 and 0.3 are not bf16
    values: the f32 table keeps the f32 sum)."""
    s = np.array([0, 0, 3])
    r = np.array([200, 200, 200])
    w = np.array([0.1, 0.3, 1.25], np.float32)
    ht, hj = both(s, r, w, 256, min_block_edges=100, cluster_agg=128)
    assert ht.cluster_count.dtype == torch.float32
    assert float(ht.cluster_count[200, 0]) == float(
        np.float32(0.1) + np.float32(0.3) + np.float32(1.25))
    assert ht.num_coo_edges == 1 and float(ht.weights[0]) == 0.0
    assert_same_operator(ht, hj)


# ---- the static term on every layout --------------------------------------

LAYOUTS = {"gridwalk": {}, "diag": dict(use_diag=True),
           "group2": dict(tile_group=2), "rowwalk": dict(use_rowwalk=True),
           "einsum": dict(use_einsum_tiles=True)}


def _static_case(semantics, seed=3, n=768):
    s, r, _ = coo(seed, n=n, pad_edges=0)
    # GCN-style self loops, then the layer's weights
    s = np.concatenate([s, np.arange(n)])
    r = np.concatenate([r, np.arange(n)])
    order = np.argsort(r, kind="stable")
    s, r = s[order], r[order]
    rng = np.random.default_rng(seed)
    gcn_w = (rng.random(len(s)) + 0.05).astype(np.float32)
    return s, r, _operator_weights(s, r, gcn_w, n, semantics)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("semantics", ["gcn_norm", "mean_nonself",
                                       "sum_nonself"])
def test_static_collapse_matches_jax(semantics, layout, bf16):
    """``hybrid_spmm`` with ``cluster_agg`` 256 and ``cluster_agg_exact`` 5
    under GCN's, SAGE's and GIN's weights, forward and ``dx``, on every
    tile layout, on f32 tiles and table and on bf16 ones."""
    n = 768
    s, r, w = _static_case(semantics)
    kw = dict(min_block_edges=60, use_segmm=True, semantics=semantics,
              cluster_agg=256, cluster_agg_exact=5, real_nodes=n,
              **LAYOUTS[layout])
    if bf16:
        kw["tile_dtype"] = BF16
    ht, hj = both(s, r, w, n, **kw)
    assert ht.bsr is not None or ht.diag_blocks is not None
    assert float(ht.cluster_count.float().abs().sum()) > 0
    rng = np.random.default_rng(4)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    g = rng.standard_normal((n, 16)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda xx: jax_hybrid_spmm(hj, xx), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    out = hybrid_spmm(ht, xt)
    out.backward(torch.from_numpy(g))
    tol = (F32_TOL if not bf16 else EINSUM_BF16_TOL if layout == "einsum"
           else BF16_TABLE_TOL)
    close(out, out_j, tol)
    close(xt.grad, dx_j, tol)


def test_static_collapse_is_the_per_edge_oracle():
    """Against float64 numpy: tiles and kept stragglers on x, collapsed
    stragglers on the member mean of their sender's cluster (the JAX
    package's oracle, ``tests/test_cluster_agg.py``)."""
    n, k_size, t = 768, 256, 60
    s, r, w = _static_case("gcn_norm", seed=7)
    h = build_hybrid(s, r, w, n, min_block_edges=t, use_segmm=True,
                     cluster_agg=k_size, real_nodes=n)
    x = np.random.default_rng(8).standard_normal((n, 16))
    dense = _dense(s, r, n, t)
    xmean = x.reshape(n // k_size, k_size, -1).mean(1)
    want = np.zeros_like(x)
    np.add.at(want, r[dense], w[dense, None] * x[s[dense]])
    col = ~dense & (w > 0)
    np.add.at(want, r[col], w[col, None] * xmean[s[col] // k_size])
    close(hybrid_spmm(h, torch.from_numpy(x.astype(np.float32))), want)


@pytest.mark.parametrize("table", ["agg_f32", "att"])
def test_padding_rows_stay_out_of_the_summaries(table):
    """600 real rows of 768 and no edge on the padding: the summaries are
    means over the real members, so the padding rows' values change
    nothing, in either package (the static output; the attention output
    and its score means)."""
    n, nr = 768, 600
    s, r, w = coo(9, n=n, real=nr, pad_edges=0)
    kw = TABLES[table](0)
    if table == "att":
        w = np.ones_like(w)
    ht, hj = both(s, r, w, n, min_block_edges=150, use_segmm=True,
                  real_nodes=nr, **kw)
    assert_same_operator(ht, hj)
    np.testing.assert_array_equal(
        f32(ht.cluster_scale),
        np.float32([128, 128, 128, 128, nr - 512, 1]) ** -1)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    x0 = x.copy()
    x0[nr:] = 0.0
    if table == "agg_f32":
        def run(xx):
            return hybrid_spmm(ht, torch.from_numpy(xx))
        ref = jax_hybrid_spmm(hj, jnp.asarray(x))
    else:
        a = (rng.standard_normal(16) / 4).astype(np.float32)
        sd = rng.standard_normal(n).astype(np.float32)

        def run(xx):
            xt = torch.from_numpy(xx)
            return tile_gat_attention(ht, xt @ torch.from_numpy(a),
                                      torch.from_numpy(sd), xt, SLOPE,
                                      att_src=torch.from_numpy(a))
        ref = jax_tile_gat_mod.tile_gat_attention(
            hj, jnp.asarray(x) @ a, jnp.asarray(sd), jnp.asarray(x), SLOPE,
            att_src=jnp.asarray(a))
    with torch.no_grad():
        out, out0 = run(x), run(x0)
    close(out, ref)
    close(out[:nr], out0[:nr].numpy())


def test_bf16_summary_sums_in_f32():
    """2,048 members of 1e-3 each in bf16 activations: a bf16 running sum
    stops absorbing terms near 0.25; the f32 sum keeps the mean (the JAX
    package's ``test_bf16_summary_accumulates_f32``)."""
    n = 2048
    h = build_hybrid(np.array([5]), np.array([1900]),
                     np.array([1.0], np.float32), n, min_block_edges=10 ** 6,
                     cluster_agg=n, real_nodes=n)
    x = torch.full((n, 8), 1e-3, dtype=BF16)
    out = hybrid_spmm(h, x).float()
    np.testing.assert_allclose(out[1900].numpy(), 1e-3, rtol=0.01)


def test_bf16_table_product_sums_in_f32():
    """A bf16 table times bf16 summaries is summed and returned in f32, as
    the JAX package's ``preferred_element_type=f32`` product: three
    summaries of 1 + 2⁻⁷ (exact in bf16) sum to 3.0234375, which bf16
    cannot hold (it would round to 3.03125)."""
    n = 384
    s = np.array([0, 128, 256])
    r = np.zeros(3, np.int64)
    w = np.ones(3, np.float32)
    ht, hj = both(s, r, w, n, min_block_edges=10 ** 6, cluster_agg=128,
                  tile_dtype=BF16)
    assert ht.cluster_count.dtype == BF16
    x = np.full((n, 4), 1 + 2 ** -7, np.float32)
    out = hybrid_spmm(ht, torch.from_numpy(x))
    ref = np.asarray(jax_hybrid_spmm(hj, jnp.asarray(x)))
    assert float(out[0, 0]) == float(ref[0, 0]) == 3.0234375


# ---- the attention collapse -------------------------------------------------

@pytest.fixture(scope="module")
def sbm_collapsed():
    """A 640-node SBM graph on the att_unit operator at a 200-edge tile
    threshold, under ``cluster_att`` 128: everything collapses (exact 0)
    or the 16 top senders keep the per-edge path."""
    x, s, r, y = sbm_graph(num_nodes=640, num_classes=4, num_features=16,
                           p_in=0.1, p_out=0.01, seed=11)
    out = {}
    for exact in (0, 16):
        kw = dict(y=y, min_block_edges=200, layer_name="GATConv", seed=0,
                  cluster_att=128, cluster_att_exact=exact)
        gt, ot = build_optimized_graph(x, s, r, **kw)
        gj, oj = jax_build_optimized_graph(x, s, r, **kw)
        np.testing.assert_array_equal(ot, oj)
        assert gt.aux.bsr is not None
        assert_same_operator(gt.aux, gj.aux)
        out[exact] = gt, gj
    assert out[0][0].aux.num_coo_edges == 1
    assert out[16][0].aux.num_coo_edges > 100
    return out


def _attention_case(ht, hj, feat, seed, sdst_shift=0.0):
    rng = np.random.default_rng(seed)
    n = ht.num_nodes
    h = rng.standard_normal((n, feat)).astype(np.float32)
    a = (rng.standard_normal(feat) / np.sqrt(feat)).astype(np.float32)
    sd = rng.standard_normal(n).astype(np.float32) + sdst_shift
    tgt = rng.standard_normal((n, feat)).astype(np.float32)

    def loss_j(hh, aa, ss):
        out = jax_tile_gat_mod.tile_gat_attention(hj, hh @ aa, ss, hh, SLOPE,
                                                  att_src=aa)
        return jnp.sum((out - tgt) ** 2), out

    (_, out_j), grads_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(h), jnp.asarray(a), jnp.asarray(sd))
    h_, a_, s_ = (torch.tensor(v, requires_grad=True) for v in (h, a, sd))
    out = tile_gat_attention(ht, h_ @ a_, s_, h_, SLOPE, att_src=a_)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    return (out_j, grads_j), (out, (h_.grad, a_.grad, s_.grad))


@pytest.mark.parametrize("exact", [0, 16])
@pytest.mark.parametrize("branch", ["default", *SWITCHES])
def test_attention_collapse_matches_jax(monkeypatch, sbm_collapsed, branch,
                                        exact):
    """``tile_gat_attention`` on the collapsed operator under every switch
    set, forward and the gradients of ``h``, ``att_src`` and
    ``score_dst``, at F=16 (K3w for the default straggler numerator)."""
    if branch != "default":
        switch(monkeypatch, branch)
    gt, gj = sbm_collapsed[exact]
    (out_j, grads_j), (out, grads) = _attention_case(gt.aux, gj.aux, 16, 3)
    close_att(out, out_j)
    for got, ref in zip(grads, grads_j):
        assert torch.isfinite(got).all()
        close_att(got, ref, grad=True)


@pytest.mark.parametrize("branch", ["exact_max", "fused_exact_max"])
def test_exact_max_folds_the_summary_rows(monkeypatch, branch):
    """No tile and every edge collapsed (self loops too): every row's
    in-edges are summary rows, and scores shifted 200 below 0 would
    underflow against any other max.  The exact max folds the summary
    rows' max, as the JAX package's does: finite and equal to it."""
    switch(monkeypatch, branch)
    s, r, _ = coo(12, n=512, e=3000, pad_edges=0)
    s = np.concatenate([s, np.arange(512)])
    r = np.concatenate([r, np.arange(512)])
    order = np.argsort(r, kind="stable")
    s, r = s[order], r[order]
    ht, hj = both(s, r, np.ones(len(s), np.float32), 512,
                  min_block_edges=10 ** 6, use_segmm=True, cluster_att=128,
                  semantics="att_unit")
    assert ht.bsr is None and ht.num_coo_edges == 1
    (out_j, grads_j), (out, grads) = _attention_case(ht, hj, 16, 4,
                                                     sdst_shift=-200.0)
    assert torch.isfinite(out).all() and float(out.detach().abs().max()) > 0
    close_att(out, out_j)
    for got, ref in zip(grads, grads_j):
        assert torch.isfinite(got).all()
        close_att(got, ref, grad=True)


# ---- the guards ---------------------------------------------------------------

GUARDS = {
    "both": (dict(cluster_att=128, cluster_agg=128, semantics="att_unit"),
             "mutually exclusive"),
    "att_static": (dict(cluster_att=128), "att_unit"),
    "agg_att_unit": (dict(cluster_agg=128, semantics="att_unit"),
                     "att_unit"),
    "k_divides": (dict(cluster_agg=384), "must divide"),
}


@pytest.mark.parametrize("case", list(GUARDS))
def test_build_hybrid_guards_match_jax(case):
    kw, match = GUARDS[case]
    s, r, w = coo(13, n=512, e=2000)
    with pytest.raises(ValueError, match=match) as got:
        build_hybrid(s, r, w, 512, min_block_edges=60, **kw)
    with pytest.raises(ValueError) as ref:
        jax_build_hybrid(s, r, w, 512, min_block_edges=60, **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("kw", [dict(cluster_agg=100), dict(cluster_att=-128,
                                                            layer_name=
                                                            "GATConv")])
def test_optimized_graph_refuses_k_off_the_block(kw):
    x, s, r = community_graph(np.random.default_rng(14), 300, 4)
    with pytest.raises(ValueError, match="positive multiple") as got:
        build_optimized_graph(x, s, r, **kw)
    with pytest.raises(ValueError) as ref:
        jax_build_optimized_graph(x, s, r, **kw)
    assert str(got.value) == str(ref.value)


# ---- the entry points' builders ---------------------------------------------

OPTIMIZED = {"GCNConv": dict(cluster_agg=256, cluster_agg_exact=6),
             "SAGEConv": dict(cluster_agg=512),
             "GINConv": dict(cluster_agg=256),
             "GATConv": dict(cluster_att=256, cluster_att_exact=6),
             "GCNConv_bf16": dict(cluster_agg=256, tile_dtype=BF16)}


@pytest.mark.parametrize("case", list(OPTIMIZED))
def test_optimized_graph_with_collapse_matches_jax(case):
    """``build_optimized_graph``: 700 nodes pad to a multiple of K (768 at
    256, 1,024 at 512), the order, the graph's arrays and the operator's
    equal to the JAX package's, ``real_nodes`` 700."""
    layer = case.split("_")[0]
    kw = dict(OPTIMIZED[case])
    x, s, r = community_graph(np.random.default_rng(15), 700, 8)
    dt = kw.pop("tile_dtype", None)
    gt, ot = build_optimized_graph(x, s, r, min_block_edges=60,
                                   layer_name=layer, tile_dtype=dt, **kw)
    gj, oj = jax_build_optimized_graph(
        x, s, r, min_block_edges=60, layer_name=layer,
        tile_dtype=None if dt is None else jnp.bfloat16, **kw)
    np.testing.assert_array_equal(ot, oj)
    k_size = kw.get("cluster_agg") or kw.get("cluster_att")
    assert gt.num_nodes_padded == gj.num_nodes_padded == -(-701 // k_size) \
        * k_size
    for k in ("x", "senders", "receivers", "edge_weight"):
        np.testing.assert_array_equal(getattr(gt, k).numpy(),
                                      np.asarray(getattr(gj, k)), err_msg=k)
    assert_same_operator(gt.aux, gj.aux)
    assert float(gt.aux.cluster_member.sum()) == 700


@pytest.mark.parametrize("kw", [dict(cluster_agg=256, cluster_agg_exact=4),
                                dict(cluster_att=128, layer_name="GATConv")])
def test_optimize_coarse_with_collapse_matches_jax(kw):
    """The Gc graph pads to a multiple of K with inert rows (zero
    features, False masks); its operator equals the JAX package's."""
    part, jpart = partitions()
    ct = optimize_coarse(part.coarse, min_block_edges=4, **kw)
    cj = jax_optimize_coarse(jpart.coarse, min_block_edges=4, **kw)
    k_size = kw.get("cluster_agg") or kw.get("cluster_att")
    assert ct.graph.num_nodes_padded % k_size == 0
    assert ct.graph.num_nodes_padded == cj.graph.num_nodes_padded
    for k in ("x", "senders", "receivers", "edge_weight"):
        np.testing.assert_array_equal(getattr(ct.graph, k).numpy(),
                                      np.asarray(getattr(cj.graph, k)),
                                      err_msg=k)
    for k in ("train_mask", "y_train", "val_mask", "y_val"):
        np.testing.assert_array_equal(getattr(ct, k).numpy(),
                                      np.asarray(getattr(cj, k)), err_msg=k)
    assert_same_operator(ct.graph.aux, cj.graph.aux)
    assert float(ct.graph.aux.cluster_member.sum()) == int(
        part.coarse.graph.n_node)


CONVS = {"GCNConv": (layers.GCNConv, jax_layers.GCNConv,
                     dict(cluster_agg=256, cluster_agg_exact=8)),
         "SAGEConv": (layers.SAGEConv, jax_layers.SAGEConv,
                      dict(cluster_agg=256)),
         "GINConv": (layers.GINConv, jax_layers.GINConv,
                     dict(cluster_agg=128, cluster_agg_exact=8)),
         "GATConv": (layers.GATConv, jax_layers.GATConv,
                     dict(cluster_att=256, cluster_att_exact=8))}


@pytest.mark.parametrize("hidden", [8, 24])
@pytest.mark.parametrize("layer", list(CONVS))
def test_conv_on_collapsed_operator_matches_jax(layer, hidden):
    """One layer of each conv on its collapsed operator with the JAX
    layer's weights: the forward and every parameter's gradient (hidden 8
    aggregates the transformed features, 24 the raw 16-wide ones)."""
    port_cls, jax_cls, kw = CONVS[layer]
    x, s, r = community_graph(np.random.default_rng(16), 700, 16)
    gt, _ = build_optimized_graph(x, s, r, min_block_edges=60,
                                  layer_name=layer, **kw)
    gj, _ = jax_build_optimized_graph(x, s, r, min_block_edges=60,
                                      layer_name=layer, **kw)
    jl = jax_cls(features=hidden)
    params = jl.init(jax.random.PRNGKey(2), gj.x, gj)
    if layer == "GINConv":
        params = {"params": {**params["params"], "eps": jnp.float32(0.3)}}
    tgt = np.random.default_rng(3).standard_normal(
        (gt.num_nodes_padded, hidden)).astype(np.float32)
    ref, vjp = jax.vjp(lambda p: jl.apply(p, gj.x, gj), params)
    (grads,) = vjp(jnp.asarray(tgt))
    mod = port_cls(16, hidden)
    mod.load_state_dict(layer_params(layer, params))
    out = mod(gt.x, gt)
    (out * torch.from_numpy(tgt)).sum().backward()
    close_att(out, ref)
    ref_grads = layer_params(layer, grads)
    for k, p in mod.named_parameters():
        assert torch.isfinite(p.grad).all(), k
        close_att(p.grad, ref_grads[k].numpy(), grad=True)


def test_collapsed_operator_moves_with_its_graph():
    """``to(device)`` carries the table, the scales and the member mask
    (here onto the CPU, as the fused Gc phase moves them to the card) and
    keeps K."""
    s, r, w = coo(17, n=512, e=2000)
    h = build_hybrid(s, r, w, 512, min_block_edges=60, use_segmm=True,
                     cluster_agg=128)
    moved = h.to("cpu")
    assert moved.cluster_size == 128
    for k in ("cluster_count", "cluster_scale", "cluster_member"):
        assert torch.equal(getattr(moved, k), getattr(h, k))
    assert dataclasses.replace(h, cluster_count=None).to("cpu") \
        .cluster_count is None


@pytest.mark.parametrize("flags", [
    ["--cluster_aggregation", "128", "--fused_epochs"],
    ["--layer_name", "GATConv", "--cluster_attention", "128",
     "--cluster_attention_exact", "8"]])
def test_cli_gc_phase_with_collapse(toy, capsys, flags):
    """The curriculum's Gc phase on a collapsed operator (forced on below
    the hybrid gate), fused or per epoch: the operator line, a finite row,
    then the Gs phase as without it."""
    from fitgnn_tpu_torch.cli.main import main
    assert main(["train", "--dataset", "toy", "--data_root",
                 str(toy / "dataset"), "--hidden", "16", "--runs", "1",
                 "--epochs1", "6", "--epochs2", "4", "--experiment",
                 "random", "--device", "cpu", "--exp_setup",
                 "Gc_train_2_Gs_train", "--hybrid_threshold", "100",
                 *flags]) == 0
    out = capsys.readouterr().out
    kind = "attention" if "--cluster_attention" in flags else "aggregation"
    assert "Gc hybrid operator: " in out
    assert f"cluster-{kind} entries (K=128, approximate)" in out
    _, rows = _rows(toy / "results" / "toy.csv")
    assert len(rows) == 1 and np.isfinite(float(rows[0]["best_loss"]))
