"""Tiles of another edge (``block=256``), the ELL operator and
``optimize_coarse(use_segmm=…, tile_group=…)`` against the JAX package, on
the CPU.

The same seeded numpy inputs go through both packages: ``build_bsr`` at
edge 256 on the grid-walk, grouped and einsum layouts (f32 and bf16
tiles); the forward and gradient of each layout (K2, K9, the einsum) and
K1's ``init + A·x``; the diagonal blocks (K8) in both orientations, from
``init`` and from zero; ``build_hybrid(block=256)`` and ``hybrid_spmm``
with and without ``use_diag``; one GCN ``gc_train_step``; the tile and
straggler counts of ``bench.py``'s graph (cut to 20,352 nodes) at 256;
``build_ell`` and ``ell_spmm``; ``optimize_coarse`` with ``use_segmm=False``
and ``tile_group=2``; GAT's operator at 256 and its fused tile attention
there; and the refusals (an edge that is not a multiple of 128, the row
walk at 256).  The JAX Pallas kernels run in interpret mode; the port's wrappers
take their plain versions because the tensors lie on the CPU.

Tolerance: forward rtol 1e-4 and atol 1e-4·max|ref|, gradients rtol 1e-3
and atol 1e-3·max|ref| (f32 sums in another order; bf16 tiles with ``x``
rounded sum exact products in f32 as well); the einsum layout on bf16
tiles, whose sums are bf16, 2e-2·max|ref|; index arrays and tiles exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.graph.build import build_graph as jax_build_graph
from fitgnn_tpu.graph.optimize import optimize_coarse as jax_optimize_coarse
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.ops import tile_gat as jax_tile_gat_mod
from fitgnn_tpu.ops.ell_spmm import build_ell as jax_build_ell
from fitgnn_tpu.ops.ell_spmm import ell_spmm as jax_ell_spmm
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.hybrid_spmm import hybrid_spmm as jax_hybrid_spmm
from fitgnn_tpu.ops.pallas.bsr_spmm import build_bsr as jax_build_bsr
from fitgnn_tpu.ops.pallas.bsr_spmm import bsr_spmm as jax_bsr_spmm
from fitgnn_tpu.ops.pallas.bsr_spmm import bsr_spmm_acc_raw
from fitgnn_tpu.ops.pallas.diag_spmm import diag_spmm_raw
from fitgnn_tpu.train import losses as jax_losses

from fitgnn_tpu_torch.graph.build import build_graph
from fitgnn_tpu_torch.graph.optimize import optimize_coarse
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.ops.bsr_spmm import (bsr_spmm_acc, bsr_spmm_fwd,
                                           bsr_spmm_grouped, bsr_spmm_plain,
                                           build_bsr)
from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm, pick_run_length
from fitgnn_tpu_torch.ops.ell_spmm import EllMatrix, build_ell, ell_spmm
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid, hybrid_spmm
from fitgnn_tpu_torch.ops.spmm import spmm
from fitgnn_tpu_torch.ops.tile_gat import tile_gat_attention
from fitgnn_tpu_torch.partition.community import hierarchical_community_order
from fitgnn_tpu_torch.train import steps

from test_torch_port_curriculum import partitions

torch.set_num_threads(1)

E = 256
BF16 = torch.bfloat16
DTYPES = {"f32": (None, None), "bf16": (BF16, jnp.bfloat16)}


def close(got, ref, grad=False, tol=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    tol = tol or (1e-3 if grad else 1e-4)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max(initial=0.0)))


def as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def sorted_coo(rng, n, e, internal=0.8, skip_block=None):
    """Receiver-sorted COO with most edges inside the 256-wide diagonal
    blocks; no edge in block row and column ``skip_block`` (of 256)."""
    r = np.sort(rng.integers(0, n, e)).astype(np.int64)
    s = np.where(rng.random(e) < internal,
                 (r // E) * E + rng.integers(0, E, e),
                 rng.integers(0, n, e)).astype(np.int64)
    w = rng.random(e).astype(np.float32)
    if skip_block is not None:
        keep = (r // E != skip_block) & (s // E != skip_block)
        s, r, w = s[keep], r[keep], w[keep]
    return s, r, w


def assert_same_bsr(bt, bj):
    for mt, mj in ((bt, bj), (bt.transpose, bj.transpose)):
        assert mt.block == mj.block == E
        np.testing.assert_array_equal(as_f32(mt.blocks), as_f32(mj.blocks))
        assert mt.blocks.dtype == (BF16 if mj.blocks.dtype == jnp.bfloat16
                                   else torch.float32)
        for name in ("rows", "cols", "row_splits"):
            np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                          np.asarray(getattr(mj, name)),
                                          err_msg=name)
        assert (mt.group, mt.einsum, mt.rowwalk) == (mj.group, mj.einsum,
                                                     mj.rowwalk)


# ---- BCSR at edge 256 -------------------------------------------------------

LAYOUTS = {"gridwalk": {}, "group2": dict(group=2),
           "einsum": dict(einsum=True)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_build_bsr_block256_matches_jax(layout, dtype):
    """(K, 256, 256) tiles, rows, cols and row_splits of both directions;
    block row 2 has no edge (a coverage filler, padded under group 2; none
    in the einsum layout)."""
    s, r, w = sorted_coo(np.random.default_rng(1), 1280, 9000, skip_block=2)
    tt, tj = DTYPES[dtype]
    bt = build_bsr(s, r, w, 1280, E, tile_dtype=tt, **LAYOUTS[layout])
    bj = jax_build_bsr(s, r, w, 1280, E, tile_dtype=tj, **LAYOUTS[layout])
    assert_same_bsr(bt, bj)
    assert bt.blocks.shape[1:] == (E, E) and bt.num_row_blocks == 5
    splits = bt.row_splits.numpy()
    assert (splits[3] == splits[2]) == (layout == "einsum")
    if bt.group > 1:
        assert (np.diff(splits) % 2 == 0).all()


WALKS = {"gridwalk": bsr_spmm_fwd, "group2": bsr_spmm_grouped}


@pytest.mark.parametrize("feat", [16, 128])
@pytest.mark.parametrize("layout,dtype", [("gridwalk", "f32"),
                                          ("gridwalk", "bf16"),
                                          ("group2", "f32"),
                                          ("group2", "bf16"),
                                          ("einsum", "f32"),
                                          ("einsum", "bf16")])
def test_bsr_spmm_block256_matches_jax(layout, dtype, feat):
    """``spmm(operator=BsrMatrix)`` at edge 256 (K2, K9 or the einsum by
    the layout) forward and gradient against the JAX ``bsr_spmm``; block
    row 2 comes out zero; the walk's plain version gives the same."""
    rng = np.random.default_rng(3)
    n = 1280
    s, r, w = sorted_coo(rng, n, 9000, skip_block=2)
    tt, tj = DTYPES[dtype]
    bt = build_bsr(s, r, w, n, E, tile_dtype=tt, **LAYOUTS[layout])
    bj = jax_build_bsr(s, r, w, n, E, tile_dtype=tj, **LAYOUTS[layout])
    x = rng.standard_normal((n, feat)).astype(np.float32)
    tgt = rng.standard_normal((n, feat)).astype(np.float32)
    _, dx_j = jax.value_and_grad(
        lambda xx: jnp.sum((jax_bsr_spmm(bj, xx) - tgt) ** 2))(jnp.asarray(x))
    tol = 2e-2 if (layout, dtype) == ("einsum", "bf16") else None
    xt = torch.tensor(x, requires_grad=True)
    out = spmm(None, None, None, xt, n, operator=bt)
    close(out, jax_bsr_spmm(bj, jnp.asarray(x)), tol=tol)
    assert not out[2 * E:3 * E].any()
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    close(xt.grad, dx_j, grad=True, tol=tol)
    if layout in WALKS:
        close(WALKS[layout](bt, torch.from_numpy(x)), out.detach())
        close(bsr_spmm_plain(bt, torch.from_numpy(x)), out.detach())
        assert WALKS[layout].launches == WALKS[layout].launches_bf16 == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("feat", [16, 128])
def test_bsr_spmm_acc_block256_matches_jax(feat, dtype):
    """K1's ``init + A·x`` at edge 256, forward and on the transpose
    structure, against ``bsr_spmm_acc_raw``."""
    rng = np.random.default_rng(4)
    n = 1280
    s, r, w = sorted_coo(rng, n, 9000, skip_block=2)
    tt, tj = DTYPES[dtype]
    bt = build_bsr(s, r, w, n, E, tile_dtype=tt)
    bj = jax_build_bsr(s, r, w, n, E, tile_dtype=tj)
    x, init = (rng.standard_normal((n, feat)).astype(np.float32)
               for _ in range(2))
    for mt, mj in ((bt, bj), (bt.transpose, bj.transpose)):
        got = bsr_spmm_acc(mt, torch.from_numpy(x), torch.from_numpy(init))
        close(got, bsr_spmm_acc_raw(mj, jnp.asarray(x), jnp.asarray(init)))
        # the empty block row keeps init as it is
        np.testing.assert_array_equal(got[2 * E:3 * E].numpy(),
                                      init[2 * E:3 * E])
    assert bsr_spmm_acc.launches == bsr_spmm_acc.launches_bf16 == 0


@pytest.mark.parametrize("feat", [16, 128])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
def test_diag_spmm_block256_matches_jax(transpose, with_init, feat):
    """K8 on four (256, 256) diagonal blocks at run length 2, block 2 all
    zero, against ``diag_spmm_raw``."""
    rng = np.random.default_rng(7)
    nb = 4
    blocks = (rng.standard_normal((nb, E, E))
              * (rng.random((nb, E, E)) < 0.05)).astype(np.float32)
    blocks[2] = 0.0
    x = rng.standard_normal((nb * E, feat)).astype(np.float32)
    init = rng.standard_normal((nb * E, feat)).astype(np.float32)
    out = diag_spmm(torch.from_numpy(blocks), torch.from_numpy(x), 2,
                    transpose=transpose,
                    init=torch.from_numpy(init) if with_init else None)
    ref = diag_spmm_raw(jnp.asarray(blocks), jnp.asarray(x), 2,
                        transpose=transpose,
                        init=jnp.asarray(init) if with_init else None)
    close(out, ref)
    np.testing.assert_array_equal(out[2 * E:3 * E].numpy(),
                                  init[2 * E:3 * E] if with_init else 0.0)
    assert diag_spmm.launches == diag_spmm.launches_bf16 == 0


# ---- the hybrid operator at edge 256 ----------------------------------------

HYBRID = {"plain": {}, "diag": dict(use_diag=True),
          "diag_bmm": dict(use_diag=True, diag_r=0),
          "group2": dict(tile_group=2),
          "einsum": dict(use_einsum_tiles=True),
          "bf16": dict(tile_dtype="bf16"),
          "bf16_diag": dict(tile_dtype="bf16", use_diag=True)}


def block_coo(rng, n, e):
    """Receiver-sorted COO on 256-node communities: 70% of the edges inside
    the community, 15% into the next one (dense off-diagonal tiles), 15%
    anywhere (stragglers)."""
    r = np.sort(rng.integers(0, n, e))
    u = rng.random(e)
    blk = np.where(u < 0.7, r // E, (r // E + 1) % (n // E))
    s = np.where(u < 0.85, blk * E + rng.integers(0, E, e),
                 rng.integers(0, n, e))
    return s, r, rng.random(e).astype(np.float32)


def _hybrid_pair(case, n=1024, e=12_000, min_block_edges=200, seed=8):
    """Both packages' operators on a 256-community COO (as
    ``tests/test_hybrid.py``'s ``TestTileBlockSize``), with dense diagonal
    and off-diagonal tiles and stragglers."""
    rng = np.random.default_rng(seed)
    s, r, w = block_coo(rng, n, e)
    kw = dict(HYBRID[case])
    bf16 = kw.pop("tile_dtype", None) is not None
    args = dict(min_block_edges=min_block_edges, block=E, use_segmm=True,
                **kw)
    return (build_hybrid(s, r, w, n, tile_dtype=BF16 if bf16 else None,
                         **args),
            jax_build_hybrid(s, r, w, n,
                             tile_dtype=jnp.bfloat16 if bf16 else None,
                             **args), (s, r, w))


@pytest.mark.parametrize("case", list(HYBRID))
def test_build_hybrid_block256_matches_jax(case):
    ht, hj, _ = _hybrid_pair(case)
    assert ht.diag_r == hj.diag_r
    assert (ht.diag_blocks is None) == (hj.diag_blocks is None)
    if ht.diag_blocks is not None:
        assert ht.diag_blocks.shape == (4, E, E)
        assert ht.diag_r == (0 if case == "diag_bmm" else pick_run_length(4))
        np.testing.assert_array_equal(as_f32(ht.diag_blocks),
                                      as_f32(hj.diag_blocks))
    for name in ("senders", "receivers", "weights", "t_senders",
                 "t_receivers", "t_weights", "t_edge_perm"):
        np.testing.assert_array_equal(getattr(ht, name).numpy(),
                                      np.asarray(getattr(hj, name)),
                                      err_msg=name)
    assert ht.num_coo_edges > 1 and hj.bsr is not None
    assert_same_bsr(ht.bsr, hj.bsr)


@pytest.mark.parametrize("feat", [16, 128])
@pytest.mark.parametrize("case", list(HYBRID))
def test_hybrid_block256_matches_jax(case, feat):
    """``hybrid_spmm`` forward and gradient at edge 256 (the chains K3 → K1,
    K3 → K8 → K1, K3 + K9, the diagonal's batched matmul) against the JAX
    package, and against the dense product on f32 tiles."""
    ht, hj, (s, r, w) = _hybrid_pair(case)
    n = ht.num_nodes
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    tgt = rng.standard_normal((n, feat)).astype(np.float32)
    _, dx_j = jax.value_and_grad(
        lambda xx: jnp.sum((jax_hybrid_spmm(hj, xx) - tgt) ** 2))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = hybrid_spmm(ht, xt)
    close(out, jax_hybrid_spmm(hj, jnp.asarray(x)))
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    close(xt.grad, dx_j, grad=True)
    if not case.startswith("bf16"):
        a = np.zeros((n, n), np.float64)
        np.add.at(a, (r, s), w)
        close(out, a @ x)


def _gcn_graphs(use_diag):
    """A 256-community graph with the GCN operator at edge 256 built by
    each package's ``build_hybrid``, as ``bench.py`` attaches it."""
    rng = np.random.default_rng(15)
    n, f = 1024, 16
    s, r, _ = block_coo(rng, n, 10_000)
    keep = s != r
    s, r = s[keep], r[keep]
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, 4, n)
    mask = rng.random(n) < 0.5
    gt = build_graph(x, s, r, y=y, train_mask=mask, node_pad_to=E)
    gj = jax_build_graph(x, s, r, y=y, train_mask=mask, node_pad_to=E)
    args = (gt.senders.numpy().astype(np.int64),
            gt.receivers.numpy().astype(np.int64), gt.edge_weight.numpy(),
            gt.num_nodes_padded)
    kw = dict(min_block_edges=150, block=E, use_segmm=True,
              use_diag=use_diag)
    ht, hj = build_hybrid(*args, **kw), jax_build_hybrid(*args, **kw)
    assert ht.bsr is not None and ht.bsr.block == E
    assert ht.num_coo_edges > 1 and (ht.diag_blocks is not None) == use_diag
    return gt._replace(aux=ht), gj._replace(aux=hj)


@pytest.mark.parametrize("use_diag", [False, True])
def test_gcn_train_step_block256_matches_jax(use_diag):
    """One ``gc_train_step`` of GCN (hidden 32, dropout off) on the edge-256
    operator: the loss and every gradient against the JAX step with the
    same converted weights."""
    gt, gj = _gcn_graphs(use_diag)
    hidden = 32
    jm = JaxNodeModel(layer_name="GCNConv", hidden=hidden, num_layers=2,
                      out_dim=4, dropout_rate=0.0)
    tiny = jax_build_graph(np.asarray(gj.x)[:8], np.arange(4), np.arange(4))
    params = jm.init(jax.random.PRNGKey(2), tiny.x, tiny)

    def loss_j(p):
        out = jm.apply(p, gj.x, gj, train=True)
        return jax_losses.masked_nll(out, gj.y, gj.train_mask)

    loss_ref, grads = jax.value_and_grad(loss_j)(params)
    model = NodeModel("GCNConv", 16, hidden, 2, 4, dropout_rate=0.0)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, params)))
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    loss = steps.gc_train_step(model, opt, gt, gt.y, gt.train_mask,
                               torch.Generator().manual_seed(7),
                               "classification")
    close(loss, loss_ref)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        close(p.grad, ref[name], grad=True)


# ---- bench.py's graph at edge 256 (cut to 20,352 nodes) --------------------

BENCH_N = 20_352    # bench.py's 169,344 (1,323 communities) cut to 159


def bench_graph():
    """``bench.py``'s community graph generator (seed 0: communities of
    128, average degree 7, 85% inside) at ``BENCH_N`` nodes, reordered by
    the port's Leiden order and normalised as ``build_optimized_graph``
    does; returns the padded graph's COO arrays."""
    rng = np.random.default_rng(0)
    e = BENCH_N * 7 // 2
    r = rng.integers(0, BENCH_N, e, dtype=np.int64)
    s = np.where(rng.random(e) < 0.85,
                 (r // 128) * 128 + rng.integers(0, 128, e),
                 rng.integers(0, BENCH_N, e))
    keep = s != r
    s, r = s[keep], r[keep]
    perm = rng.permutation(BENCH_N)
    s, r = perm[s], perm[r]
    order = hierarchical_community_order(s, r, BENCH_N, seed=0)
    inv = np.empty(BENCH_N, dtype=np.int64)
    inv[order] = np.arange(BENCH_N)
    g = build_graph(np.zeros((BENCH_N, 1), np.float32),
                    inv[s].astype(np.int32), inv[r].astype(np.int32),
                    node_pad_to=128)
    assert g.num_nodes_padded % E == 0
    return (g.senders.numpy().astype(np.int64),
            g.receivers.numpy().astype(np.int64), g.edge_weight.numpy(),
            g.num_nodes_padded)


@pytest.mark.parametrize("threshold,use_diag", [(48, False), (192, True)])
def test_bench_graph_counts_block256_match_jax(threshold, use_diag):
    """The ingest that ``chip_smoke.py`` phase 14 builds on the full graph,
    at its two thresholds: the live tiles (and diagonal blocks), the
    stragglers and the tile layout equal the JAX package's, and the
    straggler and tile edges add up to the graph's."""
    s, r, w, n = bench_graph()
    kw = dict(min_block_edges=threshold, block=E, use_diag=use_diag)
    ht = build_hybrid(s, r, w, n, **kw)
    hj = jax_build_hybrid(s, r, w, n, **kw)

    def live(blocks):
        return 0 if blocks is None else int(
            (as_f32(blocks) != 0).reshape(blocks.shape[0], -1).any(1).sum())

    def counts(h):
        return (live(h.bsr.blocks), live(h.diag_blocks),
                int((np.asarray(h.weights) != 0).sum()))

    got, ref = counts(ht), counts(hj)
    assert got == ref
    tiles, diag, stragglers = got
    assert stragglers > 0 and (diag > 0) == use_diag and tiles > 0
    # every real edge is a tile entry or a straggler
    edges = int((w != 0).sum())
    tile_nz = int((as_f32(ht.bsr.blocks) != 0).sum()) + (
        int((as_f32(ht.diag_blocks) != 0).sum()) if use_diag else 0)
    assert tile_nz + stragglers >= edges - 1 and tile_nz + stragglers <= edges
    np.testing.assert_array_equal(ht.bsr.rows.numpy(),
                                  np.asarray(hj.bsr.rows))
    np.testing.assert_array_equal(ht.bsr.cols.numpy(),
                                  np.asarray(hj.bsr.cols))


# ---- the ELL operator -------------------------------------------------------

ELL = {"buckets": dict(n=512, e=4000, max_k=4096),
       "hub": dict(n=512, e=4000, max_k=16),
       "unsorted": dict(n=256, e=1500, max_k=64, shuffle=True),
       "empty": dict(n=128, e=0, max_k=4096)}


@pytest.mark.parametrize("case", list(ELL))
def test_ell_spmm_matches_jax(case):
    """``build_ell``'s bucket tables (both directions) and ``ell_spmm``
    forward and gradient against the JAX package's, directly and through
    ``spmm(operator=EllMatrix)``; ``hub``: one node above the soft cap
    keeps every edge; ``empty``: no edge."""
    kw = dict(ELL[case])
    n, e, max_k = kw["n"], kw["e"], kw["max_k"]
    rng = np.random.default_rng(20)
    r = rng.integers(0, n - 1, e)
    s = rng.integers(0, n - 1, e)
    if case == "hub":
        r[:100] = 5                                   # degree > 100
    if not kw.get("shuffle"):
        order = np.argsort(r, kind="stable")
        s, r = s[order], r[order]
    w = rng.random(e).astype(np.float32)
    mt = build_ell(s, r, w, n, max_k=max_k)
    mj = jax_build_ell(s, r, w, n, max_k=max_k)
    assert isinstance(mt, EllMatrix)
    for at, aj in ((mt, mj), (mt.transpose, mj.transpose)):
        assert at.num_nodes == aj.num_nodes == n
        assert len(at.buckets) == len(aj.buckets) > 0
        for bt, bj in zip(at.buckets, aj.buckets):
            for name in ("rows", "cols", "weights"):
                np.testing.assert_array_equal(getattr(bt, name).numpy(),
                                              np.asarray(getattr(bj, name)),
                                              err_msg=name)
    if case == "hub":
        assert max(b.cols.shape[1] for b in mt.buckets) > max_k
    x = rng.standard_normal((n, 24)).astype(np.float32)
    tgt = rng.standard_normal((n, 24)).astype(np.float32)
    _, dx_j = jax.value_and_grad(
        lambda xx: jnp.sum((jax_ell_spmm(mj, xx) - tgt) ** 2))(
        jnp.asarray(x))
    ref = jax_ell_spmm(mj, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = spmm(None, None, None, xt, n, operator=mt)
    close(out, ref)
    close(ell_spmm(mt, torch.from_numpy(x)), ref)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    close(xt.grad, dx_j, grad=True)
    a = np.zeros((n, n), np.float64)
    np.add.at(a, (r, s), w)
    close(out, a @ x)


def test_ell_gradient_needs_the_transpose():
    rng = np.random.default_rng(21)
    s, r = rng.integers(0, 127, 300), rng.integers(0, 127, 300)
    m = build_ell(s, r, np.ones(300, np.float32), 128, with_transpose=False)
    x = torch.zeros(128, 4, requires_grad=True)
    out = ell_spmm(m, x)
    with pytest.raises(ValueError, match="with_transpose"):
        out.sum().backward()


# ---- optimize_coarse's use_segmm and tile_group -----------------------------

@pytest.mark.parametrize("kw", [dict(use_segmm=False), dict(tile_group=2)])
def test_optimize_coarse_options_match_jax(kw):
    """The Gc operator without K3's structure (the stragglers take the
    per-edge gather and segment sum) or on K9's grouped layout: its arrays
    and forward equal the JAX package's."""
    part, jpart = partitions()
    ct = optimize_coarse(part.coarse, min_block_edges=4, seed=0, **kw)
    cj = jax_optimize_coarse(jpart.coarse, min_block_edges=4, seed=0, **kw)
    ht, hj = ct.graph.aux, cj.graph.aux
    for k in ("x", "senders", "receivers", "edge_weight"):
        np.testing.assert_array_equal(getattr(ct.graph, k).numpy(),
                                      np.asarray(getattr(cj.graph, k)),
                                      err_msg=k)
    assert (ht.segmm is None) == (hj.segmm is None) == (
        not kw.get("use_segmm", True))
    assert ht.bsr is not None
    assert ht.bsr.group == hj.bsr.group == kw.get("tile_group", 1)
    for name in ("rows", "cols", "blocks"):
        np.testing.assert_array_equal(getattr(ht.bsr, name).numpy(),
                                      np.asarray(getattr(hj.bsr, name)))
    x = np.random.default_rng(22).standard_normal(
        (ct.graph.num_nodes_padded, 8)).astype(np.float32)
    with torch.inference_mode():
        out = hybrid_spmm(ht, torch.from_numpy(x))
    close(out, jax_hybrid_spmm(hj, jnp.asarray(x)))


# ---- refusals ---------------------------------------------------------------

@pytest.mark.parametrize("build", ["bsr", "hybrid"])
@pytest.mark.parametrize("block", [192, 64, 0])
def test_edge_off_128_raises(build, block):
    s, r, w = sorted_coo(np.random.default_rng(27), 768, 3000)
    with pytest.raises(ValueError, match="multiple of 128"):
        if build == "bsr":
            build_bsr(s, r, w, 768, block)
        else:
            build_hybrid(s, r, w, 768, min_block_edges=20, block=block)


@pytest.mark.parametrize("build", ["bsr", "hybrid"])
def test_rowwalk_at_256_raises_as_jax(build):
    """The row walk is 128-wide in both packages: the same ValueError."""
    s, r, w = sorted_coo(np.random.default_rng(28), 1024, 6000)
    for fn in ((build_bsr, jax_build_bsr) if build == "bsr"
               else (build_hybrid, jax_build_hybrid)):
        with pytest.raises(ValueError, match="rowwalk supports block=128"):
            if build == "bsr":
                fn(s, r, w, 1024, E, rowwalk=True)
            else:
                fn(s, r, w, 1024, min_block_edges=20, block=E,
                   use_rowwalk=True)


def test_gat_at_256_raises_naming_the_roadmap(monkeypatch):
    """GAT's operator at 256 builds as the JAX package's: ``att_unit``
    gives the same tiles, straggler lists and dynamic-tile plan; and
    ``FUSED_TILES=1`` there (which raised until K7's forms at another edge
    were ported) runs the fused tile attention as the JAX package's does,
    within the forward tolerance."""
    s, r, w = sorted_coo(np.random.default_rng(29), 1024, 6000)
    w = np.ones_like(w)
    kw = dict(min_block_edges=20, block=E, semantics="att_unit")
    hj = jax_build_hybrid(s, r, w, 1024, **kw)
    ht = build_hybrid(s, r, w, 1024, **kw)
    assert hj.bsr is not None
    assert_same_bsr(ht.bsr, hj.bsr)
    for name in ("senders", "receivers", "weights", "t_edge_perm"):
        np.testing.assert_array_equal(getattr(ht, name).numpy(),
                                      np.asarray(getattr(hj, name)),
                                      err_msg=name)
    for name in ("t_sel", "t_scale", "t_rows", "t_cols"):
        np.testing.assert_array_equal(getattr(ht.dyn_plan, name).numpy(),
                                      np.asarray(getattr(hj.dyn_plan, name)),
                                      err_msg=name)
    monkeypatch.setenv("FITGNN_GAT_FUSED_TILES", "1")
    monkeypatch.setattr(jax_tile_gat_mod, "_FUSED_TILES", True)
    rng = np.random.default_rng(30)
    ss, sd = (rng.standard_normal(1024).astype(np.float32) for _ in range(2))
    h = rng.standard_normal((1024, 8)).astype(np.float32)
    ref = jax_tile_gat_mod.tile_gat_attention(
        hj, jnp.asarray(ss), jnp.asarray(sd), jnp.asarray(h), 0.2)
    got = tile_gat_attention(ht, torch.from_numpy(ss), torch.from_numpy(sd),
                             torch.from_numpy(h), 0.2)
    close(got, ref)


def test_node_count_off_the_edge_raises():
    s, r, w = sorted_coo(np.random.default_rng(30), 640, 3000)
    for fn, kw in ((build_bsr, {}), (build_hybrid, dict(min_block_edges=20))):
        with pytest.raises(ValueError, match="multiple of"):
            fn(s, r, w, 640, block=E, **kw)
