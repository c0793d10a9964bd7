"""GAT's default tile path at tile edge 256 against the JAX package, on the
CPU.

The same seeded numpy inputs go through both packages:
``build_hybrid(block=256, semantics="att_unit")`` and its dynamic-tile plan
on f32 and bf16 tiles, on the grid-walk and einsum layouts and under the
cluster collapse (exact k of 0 and some); the plain K4, K4ᵀ and K5 against
the JAX package's ``_dyn_apply`` (both orientations) and
``_dyn_grad_blocks`` at 256; ``tile_gat_attention`` (forward and the
gradients in ``h``, ``att_src`` through ``score_src``, and ``score_dst``)
under ``GLOBAL_MAX`` 1 and 0; one GAT ``gc_train_step``; ``FUSED_TILES=1``
at 256 against the two-stage path (the fused path's own tests against the
JAX package are ``test_torch_port_fused_block.py``'s); and the refusals
(the row walk under ``att_unit`` at 256, in both packages; an edge off the
multiples of 128 in K4, K4ᵀ and K5's wrappers).
The JAX Pallas kernels run in interpret mode (its attention tests never
build ``att_unit`` at 256, so these call its functions directly); the
port's wrappers take their plain versions because the tensors lie on the
CPU.

Tolerance: forward rtol 1e-4 and atol 1e-4·max|ref|, gradients rtol 1e-3
and atol 1e-3·max|ref| (f32 sums and exps in another order); index arrays,
tiles and plans exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.graph.build import build_graph as jax_build_graph
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.ops import tile_gat as jax_tile_gat_mod
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.pallas.bsr_dynamic import _dyn_apply, _dyn_grad_blocks
from fitgnn_tpu.ops.pallas.bsr_dynamic import build_dyn_plan as jax_plan
from fitgnn_tpu.train import losses as jax_losses

from fitgnn_tpu_torch.graph.build import build_graph
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.ops.att_bsr import att_fwd, att_rowmax_plain
from fitgnn_tpu_torch.ops.bsr_dynamic import (build_dyn_plan,
                                              dyn_grad_blocks, dyn_tiles,
                                              dyn_tiles_t)
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
from fitgnn_tpu_torch.ops.tile_gat import tile_gat_attention
from fitgnn_tpu_torch.train import steps

torch.set_num_threads(1)

E = 256
N = 1024
SLOPE = 0.2
BF16 = torch.bfloat16


def close(got, ref, grad=False):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    tol = 1e-3 if grad else 1e-4
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max(initial=0.0)))


def as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def att_coo(seed, n=N, e=12_000):
    """Receiver-sorted unit-weight COO on 256-node communities: 70% of the
    edges inside the community, 15% into the next one (dense off-diagonal
    tiles), 15% anywhere (stragglers); nodes 100-119 have no edge at
    all (their exact max is −1e30)."""
    rng = np.random.default_rng(seed)
    r = np.sort(rng.integers(0, n, e))
    u = rng.random(e)
    blk = np.where(u < 0.7, r // E, (r // E + 1) % (n // E))
    s = np.where(u < 0.85, blk * E + rng.integers(0, E, e),
                 rng.integers(0, n, e))
    keep = ((r < 100) | (r >= 120)) & ((s < 100) | (s >= 120))
    s, r = s[keep], r[keep]
    return s, r, np.ones(len(r), np.float32)


# the operators: build_hybrid's arguments beside block=256 and att_unit
OPS = {"f32": {}, "bf16": dict(tile_dtype="bf16"),
       "einsum": dict(use_einsum_tiles=True),
       "einsum_bf16": dict(use_einsum_tiles=True, tile_dtype="bf16"),
       "cluster": dict(cluster_att=256),
       "cluster_exact": dict(cluster_att=256, cluster_att_exact=12)}


def operators(case, s=None, r=None, w=None, n=N, min_block_edges=200):
    """Both packages' ``att_unit`` operators at edge 256."""
    if s is None:
        s, r, w = att_coo(3)
    kw = dict(OPS[case])
    bf16 = kw.pop("tile_dtype", None) is not None
    args = dict(min_block_edges=min_block_edges, block=E, use_segmm=True,
                semantics="att_unit", **kw)
    return (build_hybrid(s, r, w, n, tile_dtype=BF16 if bf16 else None,
                         **args),
            jax_build_hybrid(s, r, w, n,
                             tile_dtype=jnp.bfloat16 if bf16 else None,
                             **args))


ARRAYS = ("senders", "receivers", "weights", "t_senders", "t_receivers",
          "t_weights", "t_edge_perm")
CLUSTER = ("cluster_count", "cluster_scale", "cluster_member")


def assert_same_split(ht, hj):
    """The tiles (both directions), the straggler lists, the collapse's
    table and the dynamic-tile plan, exactly."""
    for name in ARRAYS + (CLUSTER if hj.cluster_count is not None else ()):
        np.testing.assert_array_equal(as_f32(getattr(ht, name)),
                                      as_f32(getattr(hj, name)),
                                      err_msg=name)
    assert (ht.cluster_count is None) == (hj.cluster_count is None)
    assert ht.cluster_size == hj.cluster_size
    for mt, mj in ((ht.bsr, hj.bsr), (ht.bsr.transpose, hj.bsr.transpose)):
        assert mt.block == mj.block == E
        assert mt.blocks.shape[1:] == (E, E)
        np.testing.assert_array_equal(as_f32(mt.blocks), as_f32(mj.blocks))
        assert (mt.blocks.dtype == BF16) == (mj.blocks.dtype == jnp.bfloat16)
        for name in ("rows", "cols", "row_splits"):
            np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                          np.asarray(getattr(mj, name)),
                                          err_msg=name)
        assert mt.einsum == mj.einsum
    assert (ht.dyn_plan is None) == (hj.dyn_plan is None)
    if ht.dyn_plan is not None:
        for name in ("t_sel", "t_scale", "t_rows", "t_cols"):
            np.testing.assert_array_equal(
                getattr(ht.dyn_plan, name).numpy(),
                np.asarray(getattr(hj.dyn_plan, name)), err_msg=name)
        nb = ht.bsr.num_row_blocks
        assert nb == N // E
        for splits, rows in ((ht.dyn_plan.row_splits, ht.bsr.rows),
                             (ht.dyn_plan.t_row_splits, ht.dyn_plan.t_rows)):
            np.testing.assert_array_equal(
                splits.numpy(), np.searchsorted(rows.numpy(),
                                                np.arange(nb + 1)))


@pytest.mark.parametrize("case", list(OPS))
def test_build_hybrid_att_unit_block256_matches_jax(case):
    """Dense diagonal and next-community tiles, stragglers (or their
    collapse onto 256-node clusters, all or all but the top 12 senders),
    the grid-walk layout's plan and the einsum layout's none."""
    ht, hj = operators(case)
    assert ht.bsr is not None and ht.bsr.nnz_blocks >= 8
    assert_same_split(ht, hj)
    assert (ht.dyn_plan is None) == case.startswith("einsum")
    if case == "cluster":
        assert ht.num_coo_edges == 1                # all collapsed
    elif case == "cluster_exact":
        assert 1 < ht.num_coo_edges < operators("f32")[0].num_coo_edges
    else:
        assert ht.num_coo_edges > 500


# ---- K4, K4ᵀ and K5's plain versions at 256 ---------------------------------

def _dyn_operands(feat, seed):
    """A sorted list of 256-wide tiles covering every tile row whose tile
    column 2 is never used (a scale-0 filler slot in the transpose plan);
    sparse values, quadrant (0, 1) of every tile empty; x and g."""
    rng = np.random.default_rng(seed)
    nb = N // E
    rows = np.sort(np.concatenate([np.arange(nb), rng.integers(0, nb, 6)]))
    cols = rng.choice([0, 1, 3], len(rows))
    blocks = np.where(rng.random((len(rows), E, E)) < 0.05,
                      rng.random((len(rows), E, E)) + 0.1, 0.0)
    blocks[:, :128, 128:] = 0.0
    x = rng.standard_normal((N, feat)).astype(np.float32)
    g = rng.standard_normal((N, feat)).astype(np.float32)
    return (rows.astype(np.int32), cols.astype(np.int32), nb,
            blocks.astype(np.float32), x, g)


@pytest.mark.parametrize("feat", [16, 128])
@pytest.mark.parametrize("kernel", ["K4", "K4T", "K5"])
def test_dyn_kernels_block256_match_jax(kernel, feat):
    """K4 (``out[rows[k]] += B[k] @ x[cols[k]]``), K4ᵀ on the transpose
    plan (with its filler slot) and K5 (``dB[k] = g[rows[k]] @
    x[cols[k]]ᵀ``) on 256-wide tiles."""
    rows, cols, nb, blocks, x, g = _dyn_operands(feat, feat + 40)
    plan, pj = build_dyn_plan(rows, cols, nb), jax_plan(rows, cols, nb)
    assert plan.t_scale.numpy().tolist().count(0) == 1
    rt, ct = torch.from_numpy(rows), torch.from_numpy(cols)
    bt = torch.from_numpy(blocks)
    launches = (dyn_tiles.launches, dyn_tiles_t.launches,
                dyn_grad_blocks.launches)
    if kernel == "K4":
        k = len(rows)
        ref = _dyn_apply(jnp.asarray(blocks), jnp.asarray(rows),
                         jnp.arange(k, dtype=jnp.int32),
                         jnp.ones(k, jnp.int32), jnp.asarray(cols),
                         jnp.asarray(x), E, trans=False, interpret=True)
        got = dyn_tiles(rt, ct, plan, bt, torch.from_numpy(x))
    elif kernel == "K4T":
        ref = _dyn_apply(jnp.asarray(blocks), pj.t_rows, pj.t_sel,
                         pj.t_scale, pj.t_cols, jnp.asarray(g), E,
                         trans=True, interpret=True)
        got = dyn_tiles_t(plan, bt, torch.from_numpy(g))
        assert not got[2 * E:3 * E].any()           # the filler's block
    else:
        ref = _dyn_grad_blocks(jnp.asarray(rows), jnp.asarray(cols),
                               jnp.asarray(g), jnp.asarray(x), E,
                               interpret=True)
        got = dyn_grad_blocks(rt, ct, torch.from_numpy(g),
                              torch.from_numpy(x), E)
        assert got.shape == (len(rows), E, E)
    close(got, ref)
    assert (dyn_tiles.launches, dyn_tiles_t.launches,
            dyn_grad_blocks.launches) == launches


# ---- tile_gat_attention and a GAT step at 256 -------------------------------

def _switch(monkeypatch, global_max: bool):
    monkeypatch.setattr(jax_tile_gat_mod, "_GLOBAL_MAX", global_max)
    monkeypatch.setenv("FITGNN_GAT_GLOBAL_MAX", "1" if global_max else "0")


@pytest.mark.parametrize("case", ["f32", "bf16", "einsum", "cluster_exact"])
@pytest.mark.parametrize("global_max", [True, False], ids=["bound", "exact"])
def test_tile_gat_attention_block256_matches_jax(monkeypatch, global_max,
                                                 case):
    """``tile_gat_attention`` on the 256-wide operator (two-stage tiles
    through K4, the einsum branch, the collapse's summary rows), F = 32:
    the output and the gradients in ``h``, ``att_src`` and
    ``score_dst``."""
    _switch(monkeypatch, global_max)
    ht, hj = operators(case)
    rng = np.random.default_rng(21)
    feat = 32
    h = rng.standard_normal((N, feat)).astype(np.float32)
    a = (rng.standard_normal(feat) / np.sqrt(feat)).astype(np.float32)
    sd = rng.standard_normal(N).astype(np.float32)
    tgt = rng.standard_normal((N, feat)).astype(np.float32)

    def loss_j(hh, aa, ss):
        out = jax_tile_gat_mod.tile_gat_attention(hj, hh @ aa, ss, hh,
                                                  SLOPE, att_src=aa)
        return jnp.sum((out - tgt) ** 2), out

    (_, out_j), grads_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(h), jnp.asarray(a), jnp.asarray(sd))
    hh, at, st = (torch.tensor(v, requires_grad=True) for v in (h, a, sd))
    out = tile_gat_attention(ht, hh @ at, st, hh, SLOPE, att_src=at)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    close(out, out_j)
    for got, ref in zip((hh.grad, at.grad, st.grad), grads_j):
        assert torch.isfinite(got).all()
        close(got, ref, grad=True)


def test_exact_max_fold_block256_matches_jax():
    """The tile part of the exact max at 256 (``att_rowmax_plain``, which
    the two-stage path runs on every device) against the JAX package's
    materialised scores: −1e30 on the rows without a tile in-edge."""
    ht, hj = operators("f32")
    rng = np.random.default_rng(22)
    ss, sd = (rng.standard_normal(N).astype(np.float32) for _ in range(2))
    b = hj.bsr
    nb = N // E
    e = jnp.where(b.blocks > 0, jax.nn.leaky_relu(
        jnp.asarray(sd).reshape(nb, E)[b.rows][:, :, None]
        + jnp.asarray(ss).reshape(nb, E)[b.cols][:, None, :], SLOPE), -1e30)
    ref = jax.ops.segment_max(e.max(2), b.rows, num_segments=nb).reshape(N)
    got = att_rowmax_plain(ht.bsr.rows, ht.bsr.cols, ht.dyn_plan,
                           ht.bsr.blocks, torch.from_numpy(ss),
                           torch.from_numpy(sd), SLOPE)
    close(got, ref)
    assert (got[100:120] == -1e30).all()


def _gat_graphs(case):
    """A 256-community graph (1,000 real nodes padded to 1,024) with each
    package's ``att_unit`` operator at edge 256 attached, as
    ``build_optimized_graph`` weighs it (presence, self-loops included)."""
    rng = np.random.default_rng(17)
    s, r, _ = att_coo(17, n=1000, e=10_000)
    keep = (s != r) & (s < 1000)
    s, r = s[keep], r[keep]
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    y = rng.integers(0, 4, 1000)
    mask = rng.random(1000) < 0.5
    gt = build_graph(x, s, r, y=y, train_mask=mask, node_pad_to=E)
    gj = jax_build_graph(x, s, r, y=y, train_mask=mask, node_pad_to=E)
    w = (gt.edge_weight.numpy() > 0).astype(np.float32)
    ht, hj = operators(case, gt.senders.numpy().astype(np.int64),
                       gt.receivers.numpy().astype(np.int64), w,
                       n=gt.num_nodes_padded, min_block_edges=150)
    assert ht.bsr is not None and ht.num_coo_edges > 1
    return gt._replace(aux=ht), gj._replace(aux=hj)


@pytest.mark.parametrize("case,global_max", [("f32", True), ("bf16", False)],
                         ids=["f32-bound", "bf16-exact"])
def test_gat_train_step_block256_matches_jax(monkeypatch, case, global_max):
    """One ``gc_train_step`` of a 2-layer GAT (16 → 32 → 32 → 4, dropout
    off) on the 256-wide operator: the loss and every gradient against the
    JAX step with the same converted weights."""
    _switch(monkeypatch, global_max)
    gt, gj = _gat_graphs(case)
    hidden = 32
    jm = JaxNodeModel(layer_name="GATConv", hidden=hidden, num_layers=2,
                      out_dim=4, dropout_rate=0.0)
    tiny = jax_build_graph(np.asarray(gj.x)[:8], np.arange(4), np.arange(4))
    params = jm.init(jax.random.PRNGKey(2), tiny.x, tiny)

    def loss_j(p):
        out = jm.apply(p, gj.x, gj, train=True)
        return jax_losses.masked_nll(out, gj.y, gj.train_mask)

    loss_ref, grads = jax.value_and_grad(loss_j)(params)
    model = NodeModel("GATConv", 16, hidden, 2, 4, dropout_rate=0.0)
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


# ---- refusals ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_fused_tiles_at_256_raise_naming_the_roadmap(monkeypatch, case):
    """``FUSED_TILES=1`` on 256-wide tiles with a plan runs the fused tile
    attention (K7 at 256; it raised here until K7's forms at another edge
    were ported), which equals the two-stage path on the same operator:
    the output and the gradients in ``score_src``, ``score_dst`` and
    ``h`` (tolerance above), with no launch on the CPU."""
    ht, _ = operators(case)
    rng = np.random.default_rng(23)
    h = rng.standard_normal((N, 16)).astype(np.float32)
    ss, sd = (rng.standard_normal(N).astype(np.float32) for _ in range(2))
    tgt = torch.from_numpy(rng.standard_normal((N, 16)).astype(np.float32))

    def run():
        leaves = [torch.tensor(v, requires_grad=True) for v in (ss, sd, h)]
        out = tile_gat_attention(ht, *leaves, SLOPE)
        ((out - tgt) ** 2).sum().backward()
        return out.detach(), [v.grad for v in leaves]

    two_stage = run()
    monkeypatch.setenv("FITGNN_GAT_FUSED_TILES", "1")
    launches = (dyn_tiles.launches, att_fwd.launches, att_fwd.launches_bf16)
    fused = run()
    assert (dyn_tiles.launches, att_fwd.launches,
            att_fwd.launches_bf16) == launches
    close(fused[0], two_stage[0].numpy())
    for got, ref in zip(fused[1], two_stage[1]):
        assert torch.isfinite(got).all()
        close(got, ref.numpy(), grad=True)


@pytest.mark.parametrize("kw", [dict(use_rowwalk=True)])
def test_att_unit_opt_ins_at_256_raise(kw):
    """``use_rowwalk`` under ``att_unit`` stays at edge 128, in both
    packages: at 256 both raise ``ValueError``.  (``use_diag`` and
    ``tile_group > 1`` build at 256: ``tests/test_torch_port_gat_optins.py``
    holds them against the JAX package.)"""
    s, r, w = att_coo(4)
    for build in (build_hybrid, jax_build_hybrid):
        with pytest.raises(ValueError, match="rowwalk supports block=128"):
            build(s, r, w, N, min_block_edges=200, block=E,
                  semantics="att_unit", **kw)


@pytest.mark.parametrize("kernel", ["K4", "K4T", "K5"])
def test_dyn_kernels_refuse_an_edge_off_128(kernel):
    """Tiles of an edge that is not a multiple of 128 (192 here) raise
    ``ValueError`` in K4, K4ᵀ and K5's wrappers, as ``build_hybrid``
    refuses such an edge, on the CPU too."""
    rows = np.array([0, 1], np.int32)
    cols = np.array([1, 0], np.int32)
    plan = build_dyn_plan(rows, cols, 2)
    rt, ct = torch.from_numpy(rows), torch.from_numpy(cols)
    blocks = torch.ones((2, 192, 192))
    x = torch.ones((384, 8))
    with pytest.raises(ValueError, match="multiple of 128"):
        if kernel == "K4":
            dyn_tiles(rt, ct, plan, blocks, x)
        elif kernel == "K4T":
            dyn_tiles_t(plan, blocks, x)
        else:
            dyn_grad_blocks(rt, ct, x, x, 192)
