"""GAT's tile opt-ins under ``semantics="att_unit"`` against the JAX
package, on the CPU.

The same seeded numpy inputs go through both packages: ``build_hybrid``
with ``use_diag`` (edges 128 and 256, f32 and bf16 masks), ``tile_group=2``
(128 and 256) and ``use_rowwalk`` (128) builds the same diagonal blocks,
BCSR tile list and dynamic-tile plan (or none, where the JAX package
builds none), and the plan's occupancy words at 256 follow the
off-diagonal and group-padded lists; ``build_optimized_graph`` passes the
opt-ins through for GATConv; ``tile_gat_attention`` gives the JAX
package's output and gradients (in ``h``, ``att_src`` through
``score_src``, and ``score_dst``) on each operator, under the global and
the exact max, two-stage and fused (``FITGNN_GAT_FUSED_TILES=1``), with a
node whose every in-edge lies in a diagonal block.  The JAX Pallas
kernels run in interpret mode; the port's wrappers take their plain
versions because the tensors lie on the CPU.

Tolerances (``tests/test_torch_port_gat.py``'s): values within rtol 1e-4
and atol 1e-5·max(1, max|ref|), gradients within rtol 1e-4 and atol
1e-4·max(1, max|ref|); index arrays, tiles, blocks and plans exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.graph.optimize import \
    build_optimized_graph as jax_build_optimized_graph
from fitgnn_tpu.ops import tile_gat as jax_tile_gat_mod
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid

from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
from fitgnn_tpu_torch.ops.att_bsr import att_fwd
from fitgnn_tpu_torch.ops.bsr_dynamic import dyn_tiles
from fitgnn_tpu_torch.ops.bsr_spmm import quad_words
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
from fitgnn_tpu_torch.ops.tile_gat import tile_gat_attention

torch.set_num_threads(1)

SLOPE = 0.2
BF16 = torch.bfloat16
# the node whose every in-edge lies in its diagonal block
DIAG_ONLY = 5


def close(got, ref, grad=False):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=(1e-4 if grad else 1e-5) * scale)


def as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def att_coo(seed, block, nblocks=4, deg=12):
    """Receiver-sorted unit-weight COO on ``block``-node communities: 70% of
    the edges inside the community (dense diagonal tiles), 15% into the
    next one from an even community (dense off-diagonal tiles; the odd
    ones keep them inside, so their block rows hold one tile), 15%
    anywhere (stragglers at a threshold of ``block`` edges a tile); node
    ``DIAG_ONLY`` keeps only its in-edges from its own community, and
    nodes 100-109 have no edge at all."""
    rng = np.random.default_rng(seed)
    n = block * nblocks
    e = n * deg
    r = np.sort(rng.integers(0, n, e))
    u = rng.random(e)
    own = r // block
    nxt = np.where(own % 2 == 0, (own + 1) % nblocks, own)
    blk = np.where(u < 0.7, own, nxt)
    s = np.where(u < 0.85, blk * block + rng.integers(0, block, e),
                 rng.integers(0, n, e))
    keep = ((r < 100) | (r >= 110)) & ((s < 100) | (s >= 110))
    keep &= (r != DIAG_ONLY) | (s // block == DIAG_ONLY // block)
    s, r = s[keep], r[keep]
    assert (r == DIAG_ONLY).sum() >= 4
    return s, r, np.ones(len(r), np.float32), n


# the operators: (edge, build_hybrid's opt-ins, bf16 mask)
OPS = {"diag128": (128, dict(use_diag=True), False),
       "diag128bf": (128, dict(use_diag=True), True),
       "diag256": (256, dict(use_diag=True), False),
       "diag256bf": (256, dict(use_diag=True), True),
       "group128": (128, dict(tile_group=2), False),
       "group256": (256, dict(tile_group=2), False),
       "group256bf": (256, dict(tile_group=2), True),
       "rowwalk128": (128, dict(use_rowwalk=True), False)}


def operators(case, seed=3):
    """Both packages' ``att_unit`` operators of ``case`` on ``att_coo``."""
    block, kw, bf16 = OPS[case]
    s, r, w, n = att_coo(seed, block)
    args = dict(min_block_edges=block, block=block, use_segmm=True,
                semantics="att_unit", **kw)
    return (build_hybrid(s, r, w, n, tile_dtype=BF16 if bf16 else None,
                         **args),
            jax_build_hybrid(s, r, w, n,
                             tile_dtype=jnp.bfloat16 if bf16 else None,
                             **args), n)


ARRAYS = ("senders", "receivers", "weights", "t_senders", "t_receivers",
          "t_weights", "t_edge_perm")


@pytest.mark.parametrize("case", list(OPS))
def test_build_hybrid_att_unit_opt_ins_match_jax(case):
    """The diagonal blocks, the straggler lists, the BCSR tile list in
    both directions (the group-padded one under ``tile_group``, the row
    walk's without fillers) and the plan's arrays, exactly; a plan where
    the JAX package builds one (not on the row walk)."""
    ht, hj, _ = operators(case)
    block, kw, bf16 = OPS[case]
    for name in ARRAYS:
        np.testing.assert_array_equal(as_f32(getattr(ht, name)),
                                      as_f32(getattr(hj, name)),
                                      err_msg=name)
    assert (ht.diag_blocks is None) == (hj.diag_blocks is None) \
        == ("use_diag" not in kw)
    if ht.diag_blocks is not None:
        np.testing.assert_array_equal(as_f32(ht.diag_blocks),
                                      as_f32(hj.diag_blocks))
        assert (ht.diag_blocks.dtype == BF16) == bf16
        assert ht.diag_r == hj.diag_r
    for mt, mj in ((ht.bsr, hj.bsr), (ht.bsr.transpose, hj.bsr.transpose)):
        np.testing.assert_array_equal(as_f32(mt.blocks), as_f32(mj.blocks))
        for name in ("rows", "cols", "row_splits"):
            np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                          np.asarray(getattr(mj, name)),
                                          err_msg=name)
        assert (mt.group, mt.rowwalk) == (mj.group, mj.rowwalk)
    if "use_diag" in kw:       # the BCSR holds the off-diagonal tiles alone
        assert not (ht.bsr.rows == ht.bsr.cols)[
            ht.bsr.blocks.flatten(1).any(1)].any()
    assert (ht.dyn_plan is None) == (hj.dyn_plan is None) \
        == ("use_rowwalk" in kw)
    if ht.dyn_plan is not None:
        for name in ("t_sel", "t_scale", "t_rows", "t_cols"):
            np.testing.assert_array_equal(
                getattr(ht.dyn_plan, name).numpy(),
                np.asarray(getattr(hj.dyn_plan, name)), err_msg=name)


@pytest.mark.parametrize("case", ["diag256", "diag256bf", "group256",
                                  "group256bf"])
def test_plan_words_follow_the_opt_in_tile_lists(case):
    """At 256 the plan's occupancy words are the words of the BCSR's own
    tiles (the off-diagonal or the group-padded list): a group pad or a
    coverage filler has word 0 and no live quadrant, and ``t_words`` is 0
    on the transpose's filler slots."""
    ht, _, _ = operators(case)
    plan, b = ht.dyn_plan, ht.bsr
    assert plan.words is not None and plan.live is not None
    assert torch.equal(plan.words, quad_words(b.blocks, 256))
    empty = ~b.blocks.flatten(1).any(1)
    if "group" in case:
        assert empty.any()                  # pads in the grouped list
    assert (plan.words[empty] == 0).all()
    assert set((plan.live // 4).tolist()) == set(
        torch.nonzero(plan.words).flatten().tolist())
    assert (plan.t_words[plan.t_scale == 0] == 0).all()


@pytest.mark.parametrize("kw", [dict(use_diag=True), dict(tile_group=2)],
                         ids=["use_diag", "tile_group2"])
def test_build_optimized_graph_gat_opt_ins_match_jax(kw):
    """``build_optimized_graph(layer_name="GATConv", ...)`` builds the
    opt-in operator on the Leiden order, as the JAX package's does."""
    rng = np.random.default_rng(8)
    s, r, _, n = att_coo(8, 128)
    keep = s != r
    x = rng.standard_normal((n, 4)).astype(np.float32)
    gt, ot = build_optimized_graph(x, s[keep], r[keep], layer_name="GATConv",
                                   min_block_edges=24, **kw)
    gj, oj = jax_build_optimized_graph(x, s[keep], r[keep],
                                       layer_name="GATConv",
                                       min_block_edges=24, **kw)
    np.testing.assert_array_equal(ot, oj)
    ht, hj = gt.aux, gj.aux
    assert ht.semantics == "att_unit"
    for name in ("rows", "cols"):
        np.testing.assert_array_equal(getattr(ht.bsr, name).numpy(),
                                      np.asarray(getattr(hj.bsr, name)))
    np.testing.assert_array_equal(as_f32(ht.bsr.blocks),
                                  as_f32(hj.bsr.blocks))
    if "use_diag" in kw:
        np.testing.assert_array_equal(as_f32(ht.diag_blocks),
                                      as_f32(hj.diag_blocks))
    assert ht.dyn_plan is not None and hj.dyn_plan is not None


def _switch(monkeypatch, global_max: bool, fused: bool = False):
    monkeypatch.setattr(jax_tile_gat_mod, "_GLOBAL_MAX", global_max)
    monkeypatch.setattr(jax_tile_gat_mod, "_FUSED_TILES", fused)
    monkeypatch.setenv("FITGNN_GAT_GLOBAL_MAX", "1" if global_max else "0")
    monkeypatch.setenv("FITGNN_GAT_FUSED_TILES", "1" if fused else "0")


def _attention_vs_jax(ht, hj, n, feat=16, seed=21):
    """``tile_gat_attention`` in both packages on seeded ``h``, ``att_src``
    and ``score_dst`` (``score_src = h @ att_src``): the port's output and
    its gradients, each held against the JAX package's."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, feat)).astype(np.float32)
    a = (rng.standard_normal(feat) / np.sqrt(feat)).astype(np.float32)
    sd = rng.standard_normal(n).astype(np.float32)
    tgt = rng.standard_normal((n, feat)).astype(np.float32)

    def loss_j(hh, aa, ss):
        out = jax_tile_gat_mod.tile_gat_attention(hj, hh @ aa, ss, hh,
                                                  SLOPE, att_src=aa)
        return jnp.sum((out - tgt) ** 2), out

    # jitted: the switches are read when it traces, here
    (_, out_j), grads_j = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(h), jnp.asarray(a), jnp.asarray(sd))
    hh, at, st = (torch.tensor(v, requires_grad=True) for v in (h, a, sd))
    out = tile_gat_attention(ht, hh @ at, st, hh, SLOPE, att_src=at)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    assert torch.isfinite(out).all()
    close(out, out_j)
    for got, ref in zip((hh.grad, at.grad, st.grad), grads_j):
        assert torch.isfinite(got).all()
        close(got, ref, grad=True)
    return out


# (operator, global max, FUSED_TILES): every opt-in at each edge it takes,
# f32 and bf16 masks, both maxima, two-stage and fused
ATTENTION = [("diag128", True, False), ("diag128bf", False, False),
             ("diag256", False, False), ("diag256bf", True, False),
             ("diag128", False, True), ("diag256bf", True, True),
             ("group128", False, False), ("group256", True, True),
             ("rowwalk128", False, False)]


@pytest.mark.parametrize(
    "case,global_max,fused", ATTENTION,
    ids=[f"{c}-{'bound' if g else 'exact'}{'-fused' if f else ''}"
         for c, g, f in ATTENTION])
def test_tile_gat_opt_ins_match_jax(monkeypatch, case, global_max, fused):
    """``tile_gat_attention`` on each opt-in operator: the diagonal blocks'
    batched matmul beside the off-diagonal tiles (through K4, or K7 under
    ``FUSED_TILES=1``), the group-padded plan, and the row walk (no plan:
    the einsum branch); output and gradients, with no launch on the CPU.
    The diagonal-only node gets a non-zero output."""
    _switch(monkeypatch, global_max, fused=fused)
    ht, hj, n = operators(case)
    launches = (dyn_tiles.launches, att_fwd.launches)
    out = _attention_vs_jax(ht, hj, n)
    assert (dyn_tiles.launches, att_fwd.launches) == launches
    assert out[DIAG_ONLY].abs().sum() > 0


def test_diag_only_node_needs_the_fold(monkeypatch):
    """The diagonal-only node has no straggler and no off-diagonal tile
    in-edge, so its exact max is the diagonal fold's alone: the row max of
    its diagonal block's scores, not −1e30, and its output is finite."""
    from fitgnn_tpu_torch.ops.tile_gat import _exact_max
    _switch(monkeypatch, False)
    ht, _, n = operators("diag128")
    assert not ((ht.receivers == DIAG_ONLY) & (ht.weights > 0)).any()
    live = ht.bsr.blocks[:, DIAG_ONLY % 128].any(1)
    assert not (ht.bsr.rows[live] == DIAG_ONLY // 128).any()
    rng = np.random.default_rng(5)
    ss, sd = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              for _ in range(2))
    es = torch.full((ht.num_coo_edges,), -1e30)
    m = _exact_max(ht, es, ss, sd, SLOPE, fused=False)
    blk = DIAG_ONLY // 128
    cols = torch.nonzero(ht.diag_blocks[blk, DIAG_ONLY % 128]).flatten()
    e = sd[DIAG_ONLY] + ss[blk * 128 + cols]
    assert m[DIAG_ONLY] == torch.where(e >= 0, e, SLOPE * e).max()
    h = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    out = tile_gat_attention(ht, ss, sd, h, SLOPE)
    assert torch.isfinite(out).all()
