"""The live-quadrant list of GAT's dynamic-tile plan and K7's fused path on
a plan with occupancy words, against the JAX package, on the CPU.

Above tile edge 128, ``build_hybrid(semantics="att_unit")`` gives the
dynamic-tile plan its mask's occupancy words (``DynPlan.words``, bit
``i·nq + j`` for 128 × 128 quadrant (i, j) of a forward tile) and
``DynPlan.live``, the ids ``k·nq² + i·nq + j`` of their set bits in
ascending order.  On the card K7f walks the live quadrants of ``words``
and the score pass K7s runs one CTA a ``live`` entry; here the list itself
is checked (at edges 256 and 512, after ``.to`` and the artifact cache;
None at 128 and without words), and ``att_tiles`` at edge 256 on a plan
with words and ``live`` is held against the JAX package's ``att_tiles``,
whose Pallas kernels run in interpret mode here as its own tests run them
on the CPU: ``(num, den)`` and the gradients in ``ssrc``, ``sdst`` and
``x``, on f32 and bf16 masks.  The port's wrappers take their plain
versions because the tensors lie on the CPU.

Tolerance: forward rtol 1e-4 and atol 1e-4·max|ref|, gradients rtol 1e-3
and atol 1e-3·max|ref| (f32 sums and exps in another order), as
``test_torch_port_fused_block.py``; the list exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.ops.pallas import att_bsr as jax_att
from fitgnn_tpu.ops.pallas.bsr_dynamic import build_dyn_plan as jax_plan

from fitgnn_tpu_torch.ops import att_bsr
from fitgnn_tpu_torch.ops.bsr_dynamic import build_dyn_plan, live_quadrants
from fitgnn_tpu_torch.utils.cache import ArtifactCache

from test_torch_port_dynwords import BF16, SLOPE, att_operator, close

torch.set_num_threads(1)


def set_bits(words, nq: int) -> list:
    """The ids ``k·nq² + b`` of every set bit ``b`` of each word, in
    ascending order, bit by bit."""
    return [k * nq * nq + b for k, w in enumerate(words.tolist())
            for b in range(nq * nq) if (w >> b) & 1]


@pytest.mark.parametrize("move", ["built", "to", "cache"])
@pytest.mark.parametrize("edge", [256, 512])
def test_live_lists_the_words_set_bits(tmp_path, edge, move):
    """``live`` is (L,) int32, the set bits of ``words`` as quadrant ids in
    ascending order, a tile's quadrants adjacent; some quadrants are empty
    and some live; it survives ``.to`` and the artifact cache."""
    h = att_operator(edge, 4 * edge)
    if move == "to":
        h = h.to(torch.device("cpu"))
    elif move == "cache":
        cache = ArtifactCache(str(tmp_path))
        cache.save("op", h)
        h = cache.load("op")
    plan, nq = h.dyn_plan, edge // 128
    assert plan.live.dtype == torch.int32 and plan.live.dim() == 1
    assert plan.live.tolist() == set_bits(plan.words, nq)
    assert 0 < plan.live.numel() < plan.words.numel() * nq * nq
    assert torch.equal(plan.words, h.bsr.quad_bits)


def test_live_quadrants_reads_every_bit():
    """``live_quadrants`` at nq 2 to 8 against the bit-by-bit list, the
    sign bit of nq = 8 (quadrant (7, 7)) included; a word of 0 adds
    nothing."""
    rng = np.random.default_rng(3)
    for nq in range(2, 9):
        bits = rng.integers(0, 2, (9, nq * nq), dtype=np.uint64)
        bits[0] = 0
        bits[-1, -1] = 1
        words = (bits << np.arange(nq * nq, dtype=np.uint64)).sum(
            1, dtype=np.uint64).view(np.int64)
        ref = [k * nq * nq + b for k in range(9) for b in range(nq * nq)
               if bits[k, b]]
        assert live_quadrants(words, nq).tolist() == ref
    assert live_quadrants(np.array([-1 << 63]), 8).tolist() == [63]


def test_no_live_list_at_128_or_without_words():
    """At edge 128 (no words) and from a BCSR built with ``words=False``
    the plan has no ``live``."""
    h = att_operator(128, 1024)
    assert h.dyn_plan.words is None and h.dyn_plan.live is None
    b = dataclasses.replace(att_operator(256, 1024).bsr, words=False)
    plan = build_dyn_plan(b.rows.numpy(), b.cols.numpy(), b.num_row_blocks,
                          words=b.quad_bits, block=256)
    assert plan.words is None and plan.live is None


@pytest.mark.parametrize("tile", ["f32", "bf16"])
def test_att_tiles_on_a_plan_with_words_matches_jax(tile):
    """``att_tiles`` at edge 256, F = 16, on ``build_hybrid``'s plan with
    words and ``live`` (what K7f and K7s read on the card) against the
    JAX package's ``att_tiles`` on the same tiles and numpy inputs, ``m``
    the exact max plus a margin: ``num``, ``den`` and the gradients of
    ⟨num, g⟩ + ⟨den, dden⟩ in ``ssrc``, ``sdst`` and ``x``."""
    edge, n, feat = 256, 1024, 16
    h = att_operator(edge, n, BF16 if tile == "bf16" else None)
    b, plan = h.bsr, h.dyn_plan
    assert plan.words is not None and plan.live is not None
    assert plan.live.numel() < b.nnz_blocks * 4           # empty quadrants
    rng = np.random.default_rng(23)
    ss, sd, dden = (rng.standard_normal(n).astype(np.float32)
                    for _ in range(3))
    x, g = (rng.standard_normal((n, feat)).astype(np.float32)
            for _ in range(2))
    m = att_bsr.att_rowmax_plain(b.rows, b.cols, plan, b.blocks,
                                 torch.from_numpy(ss), torch.from_numpy(sd),
                                 SLOPE).numpy()
    m = np.where(m > -1e29, m + rng.random(n).astype(np.float32), m)

    ts, td, tx = (torch.tensor(v, requires_grad=True) for v in (ss, sd, x))
    num, den = att_bsr.att_tiles(SLOPE, b.rows, b.cols, plan, b.blocks, ts,
                                 td, torch.from_numpy(m), tx)
    grads = torch.autograd.grad((num, den), (ts, td, tx),
                                (torch.from_numpy(g), torch.from_numpy(dden)))

    jblocks = jnp.asarray(b.blocks.float().numpy())
    if tile == "bf16":
        jblocks = jblocks.astype(jnp.bfloat16)
    rows, cols = b.rows.numpy(), b.cols.numpy()
    jp = jax_plan(rows, cols, b.num_row_blocks)

    def fwd(s_, d_, x_):
        return jax_att.att_tiles(edge, SLOPE, jnp.asarray(rows),
                                 jnp.asarray(cols), jp, jblocks, s_, d_,
                                 jnp.asarray(m), x_)

    (num_j, den_j), vjp = jax.vjp(fwd, jnp.asarray(ss), jnp.asarray(sd),
                                  jnp.asarray(x))
    grads_j = vjp((jnp.asarray(g), jnp.asarray(dden)))
    close(num, num_j)
    close(den, den_j)
    for got, ref in zip(grads, grads_j):
        close(got, ref, grad=True)
