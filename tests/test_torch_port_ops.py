"""The PyTorch port's ingest and ops against the JAX package, on the CPU.

The same numpy inputs go through both packages.  The JAX Pallas kernels run
in interpret mode (their own CPU path); the port's wrappers take their plain
PyTorch versions because the tensors lie on the CPU.  Float tolerances are
atol = rtol = 1e-5: f32 sums taken in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fitgnn_tpu.data.datasets import TASK_OF as JAX_TASK_OF
from fitgnn_tpu.graph.build import build_graph as jax_build_graph
from fitgnn_tpu.graph.build import pad_graph as jax_pad_graph
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.hybrid_spmm import hybrid_spmm as jax_hybrid_spmm
from fitgnn_tpu.ops.pallas.bsr_spmm import build_bsr as jax_build_bsr
from fitgnn_tpu.ops.pallas.bsr_spmm import bsr_spmm_acc_raw
from fitgnn_tpu.ops.pallas.coo_segmm import build_segmm as jax_build_segmm
from fitgnn_tpu.ops.pallas.coo_segmm import segmm_spmm as jax_segmm_spmm
from fitgnn_tpu.ops.sddmm import sddmm_dot as jax_sddmm_dot
from fitgnn_tpu.ops.spmm import spmm_coo as jax_spmm_coo
from fitgnn_tpu.partition import community as jax_community

from fitgnn_tpu_torch.data.datasets import TASK_OF
from fitgnn_tpu_torch.graph.build import build_graph, pad_graph
from fitgnn_tpu_torch.ops.bsr_spmm import build_bsr, bsr_spmm_acc
from fitgnn_tpu_torch.ops.coo_segmm import build_segmm, segmm_spmm
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid, hybrid_spmm
from fitgnn_tpu_torch.ops.sddmm import sddmm_dot
from fitgnn_tpu_torch.ops.segment import segment_sum, take_rows
from fitgnn_tpu_torch.ops.spmm import spmm_coo
from fitgnn_tpu_torch.partition import community

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def community_edges(rng, n, deg=8, block=128, internal=0.85):
    """Directed community graph with shuffled ids (bench.py's shape)."""
    e = n * deg
    r = rng.integers(0, n, e)
    s_in = np.minimum((r // block) * block + rng.integers(0, block, e), n - 1)
    s = np.where(rng.random(e) < internal, s_in, rng.integers(0, n, e))
    keep = s != r
    perm = rng.permutation(n)
    return perm[s[keep]], perm[r[keep]]


def sorted_coo(rng, n, e, block=128, internal=0.8):
    r = np.sort(rng.integers(0, n, e)).astype(np.int64)
    s_in = (r // block) * block + rng.integers(0, block, e)
    s = np.where(rng.random(e) < internal, s_in,
                 rng.integers(0, n, e)).astype(np.int64)
    w = rng.random(e).astype(np.float32)
    return s, r, w


def test_build_graph_matches_jax():
    rng = np.random.default_rng(0)
    n = 300
    s = rng.integers(0, n, 1500)
    r = rng.integers(0, n, 1500)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    y = rng.integers(0, 4, n)
    train = rng.random(n) < 0.3
    gj = jax_build_graph(x, s, r, y=y, train_mask=train, node_pad_to=128)
    gt = build_graph(x, s, r, y=y, train_mask=train, node_pad_to=128)
    for name in ("x", "senders", "receivers", "edge_weight", "n_node",
                 "n_edge", "y", "train_mask"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gj, name)),
                                      err_msg=name)
    assert gt.val_mask is None and gt.aux is None
    assert gt.senders.dtype == torch.int32
    assert (np.diff(gt.receivers.numpy()) >= 0).all()


def test_pad_graph_matches_jax():
    """A built graph re-padded to larger shapes: every field as the JAX
    package's ``pad_graph`` gives it (the old padding edges moved onto the
    new last node); shrinking raises."""
    rng = np.random.default_rng(3)
    n = 300
    s, r = rng.integers(0, n, 1500), rng.integers(0, n, 1500)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    kw = dict(y=rng.integers(0, 4, n), train_mask=rng.random(n) < 0.3,
              val_mask=rng.random(n) < 0.3, node_pad_to=128)
    gt = build_graph(x, s, r, **kw)
    gj = jax_build_graph(x, s, r, **kw)
    e_pad = gt.senders.shape[0] + 200
    pt, pj = pad_graph(gt, 640, e_pad), jax_pad_graph(gj, 640, e_pad)
    for name in ("x", "senders", "receivers", "edge_weight", "n_node",
                 "n_edge", "y", "train_mask", "val_mask"):
        got, ref = getattr(pt, name), np.asarray(getattr(pj, name))
        assert got.dtype == getattr(gt, name).dtype, name
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
    assert pt.test_mask is None and pt.num_nodes_padded == 640
    with pytest.raises(ValueError, match="only grows"):
        pad_graph(gt, 128, e_pad)


@pytest.mark.parametrize("heads", [None, 3])
def test_sddmm_dot_matches_jax(heads):
    """``score[e] = ⟨a[send[e]], b[recv[e]]⟩``, (E,) or (E, H)."""
    rng = np.random.default_rng(4)
    shape = (50, 16) if heads is None else (50, heads, 16)
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    s, r = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
    got = sddmm_dot(torch.from_numpy(s), torch.from_numpy(r),
                    torch.from_numpy(a), torch.from_numpy(b))
    ref = np.asarray(jax_sddmm_dot(jnp.asarray(s), jnp.asarray(r),
                                   jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("weighted,resolution", [(False, 1.0), (True, 1.0),
                                                 (True, 0.5)])
def test_partition_modularity_matches_jax(weighted, resolution):
    """The Leiden library's ``modularity`` of a Leiden partition and of a
    random one, read as the JAX package reads it."""
    rng = np.random.default_rng(5)
    n = 700
    s, r = community_edges(rng, n)
    w = rng.random(len(s)) if weighted else None
    labels = community.leiden_communities(s, r, n, weight=w, seed=0)
    for lab in (labels, rng.integers(0, 9, n)):
        got = community.partition_modularity(s, r, n, lab, weight=w,
                                             resolution=resolution)
        assert isinstance(got, float)
        assert got == jax_community.partition_modularity(
            s, r, n, lab, weight=w, resolution=resolution)
    assert community.partition_modularity(s, r, n, labels, weight=w) > 0.5


def test_task_of_matches_jax():
    assert TASK_OF == JAX_TASK_OF
    assert TASK_OF["cora"] == "node_cls" and TASK_OF["QM9"] == "graph_reg"


def test_leiden_and_hierarchical_order_match_jax():
    rng = np.random.default_rng(1)
    n = 700
    s, r = community_edges(rng, n)
    np.testing.assert_array_equal(
        community.leiden_communities(s, r, n, seed=0),
        jax_community.leiden_communities(s, r, n, seed=0))
    order = community.hierarchical_community_order(s, r, n, seed=0)
    np.testing.assert_array_equal(
        order, jax_community.hierarchical_community_order(s, r, n, seed=0))
    assert np.array_equal(np.sort(order), np.arange(n))


def test_merge_and_community_order_match_jax():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 9, 400)
    np.testing.assert_array_equal(community.merge_communities(labels, 150),
                                  jax_community.merge_communities(labels, 150))
    np.testing.assert_array_equal(community.community_order(labels),
                                  jax_community.community_order(labels))


@pytest.mark.parametrize("n,feat", [(300, 16), (300, 128), (900, 16),
                                    (900, 128)])
def test_spmm_coo_matches_jax(n, feat):
    """N_pad ≤ 512 takes the dense branch, larger graphs the per-edge one."""
    rng = np.random.default_rng(3)
    s = rng.integers(0, n, 4 * n)
    r = rng.integers(0, n, 4 * n)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    gt = build_graph(x, s, r, node_pad_to=128)
    gj = jax_build_graph(x, s, r, node_pad_to=128)
    out = spmm_coo(gt.edge_weight, gt.senders, gt.receivers, gt.x,
                   gt.num_nodes_padded)
    ref = jax_spmm_coo(gj.edge_weight, gj.senders, gj.receivers, gj.x,
                       gj.num_nodes_padded)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_segment_ops():
    rng = np.random.default_rng(4)
    data = torch.from_numpy(rng.standard_normal((50, 3)).astype(np.float32))
    ids = torch.from_numpy(np.sort(rng.integers(0, 10, 50)).astype(np.int32))
    out = segment_sum(data, ids, 12)
    ref = np.zeros((12, 3), np.float32)
    np.add.at(ref, ids.numpy(), data.numpy())
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_array_equal(take_rows(data, ids).numpy(),
                                  data.numpy()[ids.numpy()])


@pytest.mark.parametrize("n_pad", [512, 1024])
def test_build_bsr_matches_jax(n_pad):
    rng = np.random.default_rng(5)
    # leave block-row 2 without edges so a coverage filler is needed
    s, r, w = sorted_coo(rng, n_pad, 6 * n_pad)
    keep = r // 128 != 2
    s, r, w = s[keep], r[keep], w[keep]
    bt, bj = build_bsr(s, r, w, n_pad), jax_build_bsr(s, r, w, n_pad)
    for mt, mj in ((bt, bj), (bt.transpose, bj.transpose)):
        for name in ("blocks", "rows", "cols", "row_splits"):
            np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                          np.asarray(getattr(mj, name)),
                                          err_msg=name)
        assert mt.num_row_blocks == mj.num_row_blocks


@pytest.mark.parametrize("feat", [16, 128])
def test_k1_plain_matches_jax(feat):
    rng = np.random.default_rng(6)
    n_pad = 768
    s, r, w = sorted_coo(rng, n_pad, 5000)
    b, bj = build_bsr(s, r, w, n_pad), jax_build_bsr(s, r, w, n_pad)
    x = rng.standard_normal((n_pad, feat)).astype(np.float32)
    init = rng.standard_normal((n_pad, feat)).astype(np.float32)
    out = bsr_spmm_acc(b, torch.from_numpy(x), torch.from_numpy(init))
    ref = bsr_spmm_acc_raw(bj, jnp.asarray(x), jnp.asarray(init))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert bsr_spmm_acc.launches == 0          # CPU: no kernel launch


def _straggler_cases():
    rng = np.random.default_rng(7)
    n = 1024
    s, r, w = sorted_coo(rng, n, 3000, internal=0.0)
    # only rows of blocks 0 and 6 receive edges: the other block-groups
    # are uncovered
    r2 = np.sort(np.concatenate([rng.integers(0, 128, 400),
                                 rng.integers(6 * 128, 7 * 128, 150)]))
    s2 = rng.integers(0, n, len(r2))
    return {"spread": (s, r, w, n),
            "uncovered_groups": (s2, r2, rng.random(len(r2)).astype(
                np.float32), n)}


@pytest.mark.parametrize("case", ["spread", "uncovered_groups"])
@pytest.mark.parametrize("feat", [16, 128])
def test_k3_plain_matches_jax(case, feat):
    s, r, w, n = _straggler_cases()[case]
    x = np.random.default_rng(8).standard_normal((n, feat)).astype(
        np.float32)
    out = segmm_spmm(build_segmm(s, r, w, n), torch.from_numpy(x))
    ref = jax_segmm_spmm(jax_build_segmm(s, r, w, n), jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert segmm_spmm.launches == 0


def test_k3_plain_matches_jax_without_stragglers():
    """Every edge in a dense tile: the straggler list is the single weight-0
    edge on the pad node, and K3 must still write all zeros."""
    n = 512
    r = np.repeat(np.arange(n), 2)
    s = (r // 128) * 128 + np.tile([0, 1], n)
    w = np.ones(len(r), np.float32)
    ht = build_hybrid(s, r, w, n, min_block_edges=8, use_segmm=True)
    hj = jax_build_hybrid(s, r, w, n, min_block_edges=8, use_segmm=True)
    assert ht.num_coo_edges == hj.num_coo_edges == 1
    x = np.random.default_rng(9).standard_normal((n, 16)).astype(np.float32)
    out = segmm_spmm(ht.segmm, torch.from_numpy(x))
    ref = jax_segmm_spmm(hj.segmm, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not out.any()


@pytest.mark.parametrize("use_segmm", [True, False])
@pytest.mark.parametrize("feat", [16, 128])
def test_hybrid_matches_jax(use_segmm, feat):
    rng = np.random.default_rng(10)
    n = 1024
    s, r, w = sorted_coo(rng, n, 9000)
    ht = build_hybrid(s, r, w, n, min_block_edges=40, use_segmm=use_segmm)
    hj = jax_build_hybrid(s, r, w, n, min_block_edges=40,
                          use_segmm=use_segmm)
    assert ht.bsr is not None and ht.num_coo_edges > 1
    assert ht.bsr.nnz_blocks == hj.bsr.nnz_blocks
    for name in ("senders", "receivers", "weights", "t_senders",
                 "t_receivers", "t_weights", "t_edge_perm"):
        np.testing.assert_array_equal(getattr(ht, name).numpy(),
                                      np.asarray(getattr(hj, name)),
                                      err_msg=name)
    for name in ("blocks", "rows", "cols", "row_splits"):
        np.testing.assert_array_equal(getattr(ht.bsr.transpose, name).numpy(),
                                      np.asarray(getattr(hj.bsr.transpose,
                                                         name)))
    x = rng.standard_normal((n, feat)).astype(np.float32)
    out = hybrid_spmm(ht, torch.from_numpy(x))
    ref = jax_hybrid_spmm(hj, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_hybrid_without_tiles_matches_jax():
    rng = np.random.default_rng(11)
    n = 512
    s, r, w = sorted_coo(rng, n, 600, internal=0.0)
    ht = build_hybrid(s, r, w, n, min_block_edges=150, use_segmm=True)
    hj = jax_build_hybrid(s, r, w, n, min_block_edges=150, use_segmm=True)
    assert ht.bsr is None and hj.bsr is None
    x = rng.standard_normal((n, 16)).astype(np.float32)
    np.testing.assert_allclose(
        hybrid_spmm(ht, torch.from_numpy(x)).numpy(),
        np.asarray(jax_hybrid_spmm(hj, jnp.asarray(x))), **TOL)


# the tile opt-ins are ported (every tile type of the JAX package, the
# einsum layout, GATConv's att_unit semantics) and so are the cluster
# collapses; a tile type outside the five raises
@pytest.mark.parametrize("opt_in", [dict(tile_dtype=torch.int8),
                                    dict(tile_dtype=torch.float16)])
def test_hybrid_opt_ins_raise(opt_in):
    """An integer tile type raises ``ValueError`` naming the five types;
    float16 tiles, once refused, give the JAX package's operator and
    product."""
    s, r, w = sorted_coo(np.random.default_rng(12), 256, 500)
    if opt_in["tile_dtype"] is torch.int8:
        with pytest.raises(ValueError, match="float8_e5m2"):
            build_hybrid(s, r, w, 256, **opt_in)
        return
    ht = build_hybrid(s, r, w, 256, min_block_edges=8, **opt_in)
    hj = jax_build_hybrid(s, r, w, 256, min_block_edges=8,
                          tile_dtype=jnp.float16)
    assert ht.bsr.blocks.dtype == torch.float16
    np.testing.assert_array_equal(ht.bsr.blocks.view(torch.int16).numpy(),
                                  np.asarray(hj.bsr.blocks).view(np.int16))
    x = np.random.default_rng(13).standard_normal((256, 16)).astype(
        np.float32)
    np.testing.assert_allclose(
        hybrid_spmm(ht, torch.from_numpy(x)).numpy(),
        np.asarray(jax_hybrid_spmm(hj, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("opt_in", [dict(cluster_att=128,
                                         semantics="att_unit"),
                                    dict(cluster_agg=128)])
def test_hybrid_cluster_opt_ins_match_jax(opt_in):
    """The cluster collapses build the JAX package's operator (the straggler
    lists that stay, the (N, C) table, its scales), and under static
    weights ``hybrid_spmm`` gives its output."""
    s, r, w = sorted_coo(np.random.default_rng(12), 256, 500)
    ht = build_hybrid(s, r, w, 256, use_segmm=True, **opt_in)
    hj = jax_build_hybrid(s, r, w, 256, use_segmm=True, **opt_in)
    assert ht.cluster_size == hj.cluster_size == 128
    for k in ("senders", "receivers", "weights", "cluster_scale",
              "cluster_member"):
        np.testing.assert_array_equal(getattr(ht, k).numpy(),
                                      np.asarray(getattr(hj, k)), err_msg=k)
    np.testing.assert_array_equal(
        ht.cluster_count.float().numpy(),
        np.asarray(hj.cluster_count.astype(jnp.float32)))
    if "cluster_agg" in opt_in:
        x = np.random.default_rng(13).standard_normal((256, 16)).astype(
            np.float32)
        np.testing.assert_allclose(
            hybrid_spmm(ht, torch.from_numpy(x)).numpy(),
            np.asarray(jax_hybrid_spmm(hj, jnp.asarray(x))), **TOL)
