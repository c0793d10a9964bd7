"""Occupancy words in GAT's dynamic-tile plan against the JAX package, on
the CPU.

Above tile edge 128, ``build_hybrid(semantics="att_unit")`` gives the
dynamic-tile plan its mask's occupancy words: ``DynPlan.words``, the
BCSR's ``quad_bits`` (bit ``i·nq + j`` set where 128 × 128 quadrant (i, j)
of a forward tile holds a non-zero), and ``DynPlan.t_words``, one word a
transpose slot: the word of the tile it reads with bit ``i·nq + j`` moved
to ``j·nq + i``, 0 on a coverage filler.  K4 and K4ᵀ walk the live
quadrants of those words on the card; here the plan itself is checked
(against words counted from the transposed tiles, at edges 256 and 512,
after ``.to`` and the artifact cache), the plan has no words at 128 or
without them, and GAT's two-stage tile path at 256 (``tiles_two_stage``
through ``bsr_spmm_dyn`` on a plan with words) is held against the JAX
package's ``bsr_spmm_dyn``, whose Pallas kernels run in interpret mode
here as its own tests run them on the CPU, in the output and in the
gradients that reach ``x`` (through K4ᵀ) and the scores (through K5).

Tolerance: forward rtol 1e-4 and atol 1e-4·max|ref|, gradients rtol 1e-3
and atol 1e-3·max|ref|, as ``test_torch_port_gat_block.py``; words
exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.pallas.bsr_dynamic import bsr_spmm_dyn as jax_spmm_dyn

from fitgnn_tpu_torch.ops.att_bsr import att_rowmax_plain
from fitgnn_tpu_torch.ops.bsr_dynamic import (build_dyn_plan,
                                              transpose_words)
from fitgnn_tpu_torch.ops.bsr_spmm import quad_words
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
from fitgnn_tpu_torch.ops.tile_gat import tiles_two_stage
from fitgnn_tpu_torch.utils.cache import ArtifactCache

torch.set_num_threads(1)

SLOPE = 0.2
BF16 = torch.bfloat16


def close(got, ref, grad=False):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    tol = 1e-3 if grad else 1e-4
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max(initial=0.0)))


def att_coo(seed, edge, n):
    """Receiver-sorted unit-weight COO on 128-node communities: 80% of the
    edges inside the community, 19% into the next one, 1% anywhere, so
    that many 128-wide quadrants of the ``edge``-wide tiles stay empty;
    no node of tile column 1 sends an edge, so the transpose plan holds a
    scale-0 filler slot there."""
    rng = np.random.default_rng(seed)
    e = 12 * n
    r = np.sort(rng.integers(0, n, e))
    u = rng.random(e)
    com = np.where(u < 0.8, r // 128, (r // 128 + 1) % (n // 128))
    s = np.where(u < 0.99, com * 128 + rng.integers(0, 128, e),
                 rng.integers(0, n, e))
    keep = s // edge != 1
    return s[keep], r[keep], np.ones(int(keep.sum()), np.float32)


def att_operator(edge, n, tile_dtype=None, min_block_edges=40, seed=5):
    s, r, w = att_coo(seed, edge, n)
    return build_hybrid(s, r, w, n, min_block_edges=min_block_edges,
                        block=edge, use_segmm=True, semantics="att_unit",
                        tile_dtype=tile_dtype)


def transposed_tile_words(h) -> torch.Tensor:
    """The words a transpose slot should carry, counted here from the
    tiles it reads, transposed: 0 where its scale is 0."""
    b, plan = h.bsr, h.dyn_plan
    tiles = b.blocks.index_select(0, plan.t_sel.long()).transpose(1, 2)
    return torch.where(plan.t_scale != 0, quad_words(tiles, b.block), 0)


# ---- the plan's words -------------------------------------------------------

@pytest.mark.parametrize("edge,tile", [(256, "f32"), (256, "bf16"),
                                       (512, "f32")])
def test_plan_words_are_the_masks_quad_bits(edge, tile):
    """The forward words are the BCSR's ``quad_bits``, which are the
    occupancy of its tiles; some quadrants are empty, some tiles whole."""
    h = att_operator(edge, 4 * edge, BF16 if tile == "bf16" else None)
    b, plan = h.bsr, h.dyn_plan
    assert b.block == edge and plan is not None
    assert plan.words.dtype == torch.int64
    assert torch.equal(plan.words, b.quad_bits)
    nq = edge // 128
    live = (b.blocks.float() != 0).reshape(-1, nq, 128, nq, 128).any(4).any(2)
    assert torch.equal(plan.words, (live.reshape(-1, nq * nq).long()
                                    << torch.arange(nq * nq)).sum(1))
    assert 0 < int(live.sum()) < live.numel()


@pytest.mark.parametrize("move", ["built", "to", "cache"])
@pytest.mark.parametrize("edge", [256, 512])
def test_t_words_are_the_transposed_tiles_words(tmp_path, edge, move):
    """Each transpose slot's word equals the word counted from its tile
    transposed; the scale-0 filler slot's word is 0 although the tile it
    names (tile 0) has live quadrants; both fields survive ``.to`` and the
    artifact cache's round trip."""
    h = att_operator(edge, 4 * edge)
    if move == "to":
        h = h.to(torch.device("cpu"))
    elif move == "cache":
        cache = ArtifactCache(str(tmp_path))
        cache.save("op", h)
        h = cache.load("op")
    plan = h.dyn_plan
    assert plan.t_words.dtype == torch.int64
    assert plan.t_words.shape == plan.t_sel.shape
    assert torch.equal(plan.t_words, transposed_tile_words(h))
    filler = plan.t_scale == 0
    assert int(filler.sum()) == 1 and int(plan.t_rows[filler]) == 1
    assert int(h.bsr.quad_bits[0]) != 0 and not plan.t_words[filler].any()
    assert torch.equal(plan.words, h.bsr.quad_bits)


def test_transpose_words_moves_every_bit():
    """``transpose_words`` against a bit-by-bit reference at nq 2 to 8,
    the sign bit (quadrant (7, 7)) and bit 7 (quadrant (0, 7) → (7, 0))
    included; transposing twice gives the words back."""
    rng = np.random.default_rng(0)
    for nq in range(2, 9):
        bits = nq * nq
        w = rng.integers(0, 2, (64, bits), dtype=np.uint64)
        w[0] = 1
        words = (w << np.arange(bits, dtype=np.uint64)).sum(
            1, dtype=np.uint64).view(np.int64)
        ref = np.zeros(64, dtype=np.uint64)
        for i in range(nq):
            for j in range(nq):
                ref |= w[:, i * nq + j] << np.uint64(j * nq + i)
        got = transpose_words(words, nq)
        np.testing.assert_array_equal(got, ref.view(np.int64))
        np.testing.assert_array_equal(transpose_words(got, nq), words)
    assert transpose_words(np.array([-1 << 63]), 8)[0] == -1 << 63
    assert transpose_words(np.array([1 << 7]), 8)[0] == 1 << 56


def test_plan_has_no_words_at_128_or_without_them():
    """At edge 128 the BCSR makes no words, so its plan carries none; a
    BCSR built with ``words=False`` neither; words at an edge the walk
    does not take, or of another length than the tiles, raise."""
    h = att_operator(128, 1024)
    assert h.bsr.block == 128 and h.bsr.quad_bits is None
    assert h.dyn_plan.words is None and h.dyn_plan.t_words is None
    b = att_operator(256, 1024).bsr
    off = dataclasses.replace(b, words=False)
    assert off.quad_bits is None
    plan = build_dyn_plan(off.rows.numpy(), off.cols.numpy(),
                          off.num_row_blocks, words=off.quad_bits,
                          block=256)
    assert plan.words is None and plan.t_words is None
    rows, cols = b.rows.numpy(), b.cols.numpy()
    for block in (128, 384 + 64, 2048):
        with pytest.raises(ValueError, match="tile edge"):
            build_dyn_plan(rows, cols, b.num_row_blocks, words=b.quad_bits,
                           block=block)
    with pytest.raises(ValueError, match="tiles"):
        build_dyn_plan(rows, cols, b.num_row_blocks,
                       words=b.quad_bits[1:], block=256)


# ---- GAT's two-stage tile path at 256 with words ----------------------------

@pytest.mark.parametrize("tile", ["f32", "bf16"])
def test_two_stage_path_with_words_matches_jax(tile):
    """``tiles_two_stage`` at edge 256 on the plan with words (``pe``, then
    ``bsr_spmm_dyn``: K4 forward, K4ᵀ for ``dx``, K5 for the tile
    gradient) against the JAX package's ``bsr_spmm_dyn`` on the same
    ``pe``, F = 24: the numerator and the gradients in ``x``, ``ssrc`` and
    ``sdst`` of ⟨num, tgt⟩."""
    edge, n, feat = 256, 1024, 24
    s, r, w = att_coo(9, edge, n)
    td = (BF16, jnp.bfloat16) if tile == "bf16" else (None, None)
    args = dict(min_block_edges=40, block=edge, use_segmm=True,
                semantics="att_unit")
    ht = build_hybrid(s, r, w, n, tile_dtype=td[0], **args)
    hj = jax_build_hybrid(s, r, w, n, tile_dtype=td[1], **args)
    assert ht.dyn_plan.words is not None and ht.dyn_plan.t_words is not None
    assert (ht.dyn_plan.t_scale == 0).any()
    rng = np.random.default_rng(11)
    x, tgt = (rng.standard_normal((n, feat)).astype(np.float32)
              for _ in range(2))
    ss, sd = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    b = ht.bsr
    m = att_rowmax_plain(b.rows, b.cols, ht.dyn_plan, b.blocks,
                         torch.from_numpy(ss), torch.from_numpy(sd),
                         SLOPE).numpy()

    bj = hj.bsr
    nb = n // edge
    mask = bj.blocks > 0

    def loss_j(xx, ssrc, sdst):
        e = jnp.where(mask, jax.nn.leaky_relu(
            sdst.reshape(nb, edge)[bj.rows][:, :, None]
            + ssrc.reshape(nb, edge)[bj.cols][:, None, :], SLOPE), -1e30)
        mrow = jnp.asarray(m).reshape(nb, edge)[bj.rows]
        pe = jnp.where(mask, jnp.exp(e - mrow[:, :, None]), 0.0)
        num = jax_spmm_dyn(bj.rows, bj.cols, hj.dyn_plan, pe, xx)
        return jnp.sum(num * tgt), num

    (_, num_j), grads_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(x), jnp.asarray(ss), jnp.asarray(sd))
    leaves = [torch.tensor(v, requires_grad=True) for v in (x, ss, sd)]
    num, _ = tiles_two_stage(SLOPE, b.rows, b.cols, ht.dyn_plan, b.blocks,
                             leaves[1], leaves[2], torch.from_numpy(m),
                             leaves[0])
    (num * torch.from_numpy(tgt)).sum().backward()
    close(num, num_j)
    for got, ref in zip(leaves, grads_j):
        assert torch.isfinite(got.grad).all()
        close(got.grad, ref, grad=True)
