"""K5 (the dynamic tiles' gradient) on the live quadrants of GAT's plan,
against the JAX package, on the CPU.

Above tile edge 128 the dynamic-tile plan lists the live 128 × 128
quadrants of its mask (``DynPlan.live``, ids ``k·nq² + i·nq + j``,
ascending), and ``bsr_spmm_dyn``'s backward hands the list to K5
(``dyn_grad_blocks``): on the card a CTA runs only on each listed
quadrant and every other quadrant of ``dB`` is written as +0; here the
plain version takes the same list and zeroes the same quadrants, because
the tensors lie on the CPU.  On the listed quadrants ``dB`` is the JAX
package's dense product (``_dyn_grad_blocks``, its Pallas kernel in
interpret mode as its own tests run it on the CPU); on the others it is
+0 where the JAX kernel gives ``g·xᵀ`` (the divergence ``ROADMAP.md`` §3
records).  GAT reads ``dB`` only under its mask, so the two-stage tile
path at 256 gives the gradients in ``x``, ``ssrc`` and ``sdst`` bit for
bit with and without the list, within tolerance of the JAX package's.

Tolerance: rtol 1e-4 and atol 1e-4·max|ref| for a product, rtol 1e-3 and
atol 1e-3·max|ref| for the gradients through the softmax, as
``test_torch_port_dynwords.py``; the zeros and the two paths exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.pallas.bsr_dynamic import _dyn_grad_blocks
from fitgnn_tpu.ops.pallas.bsr_dynamic import bsr_spmm_dyn as jax_spmm_dyn

from fitgnn_tpu_torch.ops.att_bsr import att_rowmax_plain
from fitgnn_tpu_torch.ops.bsr_dynamic import (bsr_spmm_dyn, dyn_grad_blocks,
                                              dyn_grad_blocks_plain)
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
from fitgnn_tpu_torch.ops.tile_gat import tiles_two_stage

from test_torch_port_dynwords import BF16, SLOPE, att_coo, att_operator, close

torch.set_num_threads(1)


def by_quadrant(t, edge: int):
    """(K, E, E) tiles as (K·nq², 128, 128) quadrants in id order."""
    t = torch.as_tensor(np.array(t)) if not torch.is_tensor(t) else t
    k, nq = t.shape[0], edge // 128
    return t.reshape(k, nq, 128, nq, 128).transpose(2, 3).reshape(
        k * nq * nq, 128, 128)


def listed(live, count: int) -> torch.Tensor:
    keep = torch.zeros(count, dtype=torch.bool)
    keep[live.long()] = True
    return keep


@pytest.mark.parametrize("edge", [256, 512])
def test_plain_zeroes_the_quadrants_off_the_live_list(edge):
    """``dyn_grad_blocks`` on CPU tensors with ``build_hybrid``'s
    ``plan.live`` (its plain version, no launch counted): on every listed
    quadrant the JAX package's ``_dyn_grad_blocks`` and, bit for bit, the
    plain version without the list; on every other quadrant +0, some of
    them in tiles that keep live quadrants."""
    n, feat = 4 * edge, 16
    h = att_operator(edge, n)
    b, plan = h.bsr, h.dyn_plan
    rng = np.random.default_rng(edge + 7)
    g, x = (rng.standard_normal((n, feat)).astype(np.float32)
            for _ in range(2))
    launches = dyn_grad_blocks.launches
    got = dyn_grad_blocks(b.rows, b.cols, torch.from_numpy(g),
                          torch.from_numpy(x), edge, plan.live)
    full = dyn_grad_blocks_plain(b.rows, b.cols, torch.from_numpy(g),
                                 torch.from_numpy(x), edge)
    ref = _dyn_grad_blocks(jnp.asarray(b.rows.numpy()),
                           jnp.asarray(b.cols.numpy()), jnp.asarray(g),
                           jnp.asarray(x), edge, interpret=True)
    assert dyn_grad_blocks.launches == launches
    assert got.shape == (b.nnz_blocks, edge, edge)
    q, keep = by_quadrant(got, edge), listed(plan.live, got.shape[0]
                                             * (edge // 128) ** 2)
    assert 0 < int(keep.sum()) < keep.numel()
    close(q[keep], by_quadrant(np.asarray(ref), edge)[keep].numpy())
    assert torch.equal(q[keep], by_quadrant(full, edge)[keep])
    dead = q[~keep]
    assert (dead == 0).all() and not dead.signbit().any()
    # a tile with a live quadrant and an empty one
    per_tile = keep.reshape(got.shape[0], -1)
    assert (per_tile.any(1) & ~per_tile.all(1)).any()


def test_plain_live_leaves_out_an_inf_only_unlisted_quadrants_reach():
    """An inf in g at a row of the lower half of tile row ``rows[1]`` and
    in x at a row of the right half of tile column ``cols[1]``, every
    quadrant that reads them off the list: the product with the list is
    finite, and equals the dense product on the listed quadrants, where
    the product without it is not finite."""
    edge, feat, nb = 256, 24, 4
    rng = np.random.default_rng(31)
    rows = np.sort(np.concatenate([np.arange(nb), rng.integers(0, nb, 8)]))
    cols = rng.choice([0, 1, 3], len(rows))
    keep = rng.random((len(rows), 2, 2)) < 0.7
    keep[rows == rows[1], 1, :] = False
    keep[cols == cols[1], :, 1] = False
    keep = torch.from_numpy(keep.reshape(-1))
    live = torch.from_numpy(np.flatnonzero(keep.numpy()).astype(np.int32))
    g, x = (torch.from_numpy(rng.standard_normal(
        (nb * edge, feat)).astype(np.float32)) for _ in range(2))
    g[int(rows[1]) * edge + 150, 3] = float("inf")
    x[int(cols[1]) * edge + 200, 5] = float("-inf")
    rt = torch.from_numpy(rows.astype(np.int32))
    ct = torch.from_numpy(cols.astype(np.int32))
    got = dyn_grad_blocks(rt, ct, g, x, edge, live)
    full = dyn_grad_blocks_plain(rt, ct, g, x, edge)
    assert torch.isfinite(got).all() and not torch.isfinite(full).all()
    assert torch.equal(by_quadrant(got, edge)[keep],
                       by_quadrant(full, edge)[keep])


def test_bsr_spmm_dyn_tile_gradient_is_zero_off_the_live_quadrants():
    """``bsr_spmm_dyn``'s backward passes the plan's ``live`` to K5: the
    gradient in the tile values (a leaf here) is the JAX package's
    ``bsr_spmm_dyn`` VJP on the listed quadrants and +0 on the others (the
    contract's divergence), and the gradient in ``x`` is the JAX
    package's."""
    edge, n, feat = 256, 1024, 24
    s, r, w = att_coo(13, edge, n)
    args = dict(min_block_edges=40, block=edge, use_segmm=True,
                semantics="att_unit")
    ht, hj = (build(s, r, w, n, **args)
              for build in (build_hybrid, jax_build_hybrid))
    b, plan = ht.bsr, ht.dyn_plan
    rng = np.random.default_rng(17)
    pe = np.where(b.blocks.numpy() != 0,
                  rng.random(b.blocks.shape), 0.0).astype(np.float32)
    x, tgt = (rng.standard_normal((n, feat)).astype(np.float32)
              for _ in range(2))
    tb = torch.tensor(pe, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out = bsr_spmm_dyn(b.rows, b.cols, plan, tb, tx)
    (out * torch.from_numpy(tgt)).sum().backward()

    def loss_j(blocks, xx):
        return jnp.sum(jax_spmm_dyn(hj.bsr.rows, hj.bsr.cols, hj.dyn_plan,
                                    blocks, xx) * tgt)

    db_j, dx_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(pe),
                                                   jnp.asarray(x))
    keep = listed(plan.live, b.nnz_blocks * 4)
    assert 0 < int(keep.sum()) < keep.numel()
    q = by_quadrant(tb.grad, edge)
    close(q[keep], by_quadrant(np.asarray(db_j), edge)[keep].numpy())
    assert (q[~keep] == 0).all() and not q[~keep].signbit().any()
    close(tx.grad, dx_j, grad=True)


@pytest.mark.parametrize("tile", ["f32", "bf16"])
def test_two_stage_gradients_bit_equal_with_and_without_live(tile):
    """``tiles_two_stage`` at edge 256, F = 24, on ``build_hybrid``'s plan
    (K5 on its ``live`` list) and on the same plan without the list (the
    dense K5): the gradients of ⟨num, tgt⟩ + ⟨den, dden⟩ in ``x``,
    ``ssrc`` and ``sdst`` bit for bit the same, and within tolerance of
    the JAX package's (``bsr_spmm_dyn`` on the same ``pe``)."""
    edge, n, feat = 256, 1024, 24
    s, r, w = att_coo(21, edge, n)
    td = (BF16, jnp.bfloat16) if tile == "bf16" else (None, None)
    args = dict(min_block_edges=40, block=edge, use_segmm=True,
                semantics="att_unit")
    ht = build_hybrid(s, r, w, n, tile_dtype=td[0], **args)
    hj = jax_build_hybrid(s, r, w, n, tile_dtype=td[1], **args)
    b, plan = ht.bsr, ht.dyn_plan
    assert plan.live is not None and plan.live.numel() < b.nnz_blocks * 4
    rng = np.random.default_rng(29)
    x, tgt = (rng.standard_normal((n, feat)).astype(np.float32)
              for _ in range(2))
    ss, sd, dden = (rng.standard_normal(n).astype(np.float32)
                    for _ in range(3))
    m = att_rowmax_plain(b.rows, b.cols, plan, b.blocks,
                         torch.from_numpy(ss), torch.from_numpy(sd),
                         SLOPE).numpy()

    def grads(p):
        leaves = [torch.tensor(v, requires_grad=True) for v in (x, ss, sd)]
        num, den = tiles_two_stage(SLOPE, b.rows, b.cols, p, b.blocks,
                                   leaves[1], leaves[2], torch.from_numpy(m),
                                   leaves[0])
        return torch.autograd.grad((num, den), leaves, (
            torch.from_numpy(tgt), torch.from_numpy(dden)))

    got = grads(plan)
    for a, c in zip(got, grads(dataclasses.replace(plan, live=None))):
        assert torch.isfinite(a).all() and torch.equal(a, c)

    bj, nb = hj.bsr, n // edge
    mask = bj.blocks > 0

    def loss_j(xx, ssrc, sdst):
        e = jnp.where(mask, jax.nn.leaky_relu(
            sdst.reshape(nb, edge)[bj.rows][:, :, None]
            + ssrc.reshape(nb, edge)[bj.cols][:, None, :], SLOPE), -1e30)
        mrow = jnp.asarray(m).reshape(nb, edge)[bj.rows]
        pe = jnp.where(mask, jnp.exp(e - mrow[:, :, None]), 0.0)
        num = jax_spmm_dyn(bj.rows, bj.cols, hj.dyn_plan, pe, xx)
        den = jnp.zeros((nb, edge)).at[bj.rows].add(pe.sum(2)).reshape(-1)
        return jnp.sum(num * tgt) + jnp.sum(den * dden)

    grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(ss), jnp.asarray(sd))
    for a, ref in zip(got, grads_j):
        close(a, ref, grad=True)
