"""K7sums at tile edge 256 on a plan with occupancy words, against the JAX
package, on the CPU.

On the card ``att_sums`` reads only the partials of the live quadrants:
bit ``h·nq + u`` of ``DynPlan.words[k]`` for ``rpart[k, u·E + 128·h :
+128]`` and of ``DynPlan.t_words[s]`` for ``cpart[t_sel[s], u·E + 128·h :
+128]``, a tile without a set bit in the half skipped whole.  That is the
sum of every partial bit for bit only where the partials of a clear bit
are zeros.  Here, on ``build_hybrid(block=256, semantics="att_unit")``'s
plan (f32 and bf16 masks; and at edge 512, nq = 4): the score pass's
partials (``att_scores_plain``, the dense computation the card's pass
gives to rounding) are exactly +0 on every quadrant whose bit is clear,
in ``words`` and in ``t_words``; and the skip rule, written here in numpy
(the clear bits' partials dropped, the rest added in tile order, as the
kernel adds them), is ``att_sums_plain`` bit for bit and the JAX
package's ``dsdst`` and ``dssrc`` (``_att_bwd_f`` and ``_att_bwd_t`` in
interpret mode, as its own tests run them on the CPU) within the
tolerance below.

Tolerance: rtol 1e-3 and atol 1e-3·max|ref| against the JAX package (f32
sums in another order), as ``test_torch_port_fused_block.py``'s score
gradients; the zeros and the skip rule exactly.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fitgnn_tpu.ops.pallas import att_bsr as jax_att
from fitgnn_tpu.ops.pallas.bsr_dynamic import build_dyn_plan as jax_plan

from fitgnn_tpu_torch.ops import att_bsr

from test_torch_port_dynwords import BF16, SLOPE, att_operator, close

torch.set_num_threads(1)

FEAT = 16
CASES = [(256, "f32"), (256, "bf16"), (512, "f32")]


def _case(edge, tile):
    """The operator, its plan and the score pass's inputs (seeded numpy):
    ``m`` the exact max plus a margin, unit-normal scores, features,
    cotangents and ``dden``."""
    n = 4 * edge
    h = att_operator(edge, n, BF16 if tile == "bf16" else None)
    b, plan = h.bsr, h.dyn_plan
    assert plan.words is not None and plan.t_words is not None
    rng = np.random.default_rng(37)
    ss, sd, dden = (rng.standard_normal(n).astype(np.float32)
                    for _ in range(3))
    x, g = (rng.standard_normal((n, FEAT)).astype(np.float32)
            for _ in range(2))
    m = att_bsr.att_rowmax_plain(b.rows, b.cols, plan, b.blocks,
                                 torch.from_numpy(ss), torch.from_numpy(sd),
                                 SLOPE).numpy()
    m = np.where(m > -1e29, m + rng.random(n).astype(np.float32), m)
    vec = dict(ssrc=ss, sdst=sd, m=m.astype(np.float32), g=g, x=x,
               dden=dden)
    return b, plan, vec


def _partials(b, plan, vec):
    t = {k: torch.from_numpy(v) for k, v in vec.items()}
    return att_bsr.att_scores_plain(b.rows, b.cols, plan, b.blocks,
                                    t["ssrc"], t["sdst"], t["m"], t["g"],
                                    t["x"], t["dden"], SLOPE)


def _bit(word: int, i: int) -> bool:
    return bool((word >> i) & 1)


def _half(part, k: int, u: int, h: int) -> np.ndarray:
    """The 128 partials of tile k over quadrant u of half h."""
    e = part.shape[1] // math.isqrt(part.shape[1] // 128)
    return part[k, u * e + 128 * h:u * e + 128 * (h + 1)]


def _skip_rule(plan, nq, cpart, rpart):
    """``(dssrc, dsdst)`` as the words launch adds them: per 128-row block
    (half h of its tile row or column), the slots in order, each tile's
    partials of the set bits ``h·nq + u`` summed in order (the first
    without an add), then added (``scale·t`` for dssrc, a scale-0 filler
    skipped); a tile without a set bit adds nothing."""
    cp, rp = cpart.numpy(), rpart.numpy()
    words = [int(w) for w in plan.words]
    t_words = [int(w) for w in plan.t_words]
    t_sel, t_scale = plan.t_sel.tolist(), plan.t_scale.tolist()
    splits, t_splits = plan.row_splits.tolist(), plan.t_row_splits.tolist()
    nb = (len(splits) - 1) * nq
    dssrc, dsdst = np.zeros((2, nb, 128), np.float32)

    def tile_sum(part, k, word, h):
        t = None
        for u in range(nq):
            if _bit(word, h * nq + u):
                q = _half(part, k, u, h)
                t = q.copy() if t is None else t + q
        return t

    for blk in range(nb):
        r, h = divmod(blk, nq)
        v = np.zeros(128, np.float32)
        for k in range(splits[r], splits[r + 1]):
            t = tile_sum(rp, k, words[k], h)
            if t is not None:
                v = v + t
        dsdst[blk] = v
        v = np.zeros(128, np.float32)
        for s in range(t_splits[r], t_splits[r + 1]):
            if t_scale[s] == 0:
                continue
            t = tile_sum(cp, t_sel[s], t_words[s], h)
            if t is not None:
                v = v + np.float32(t_scale[s]) * t
        dssrc[blk] = v
    return dssrc.reshape(-1), dsdst.reshape(-1)


@pytest.mark.parametrize("edge,tile", CASES)
def test_partials_of_a_clear_bit_are_plus_zero(edge, tile):
    """The contract the words launch relies on: on every quadrant whose
    bit is clear in ``plan.words`` (both partials of the tile) and in
    ``plan.t_words`` (the column partials a slot reads), the pass's
    partials are +0, sign included; the plan has clear bits and set ones."""
    b, plan, vec = _case(edge, tile)
    nq = edge // 128
    cpart, rpart = (p.numpy() for p in _partials(b, plan, vec))
    clear = 0
    for k, w in enumerate(int(w) for w in plan.words):
        for qi in range(nq):
            for qj in range(nq):
                if _bit(w, qi * nq + qj):
                    continue
                clear += 1
                for q in (_half(rpart, k, qj, qi), _half(cpart, k, qi, qj)):
                    assert (q == 0).all() and not np.signbit(q).any()
    assert 0 < clear < len(plan.words) * nq * nq
    for s, w in enumerate(int(w) for w in plan.t_words):
        if int(plan.t_scale[s]) == 0:
            assert w == 0
            continue
        k = int(plan.t_sel[s])
        for h in range(nq):
            for u in range(nq):
                if not _bit(w, h * nq + u):
                    q = _half(cpart, k, u, h)
                    assert (q == 0).all() and not np.signbit(q).any()


@pytest.mark.parametrize("edge,tile", CASES)
def test_skip_rule_is_the_plain_sum_and_matches_jax(edge, tile):
    """The clear bits' partials dropped, the rest added in tile order:
    ``att_sums_plain`` bit for bit (the dense sum, every partial read),
    and within tolerance of the JAX package's ``dsdst`` (``_att_bwd_f``)
    and ``dssrc`` (``_att_bwd_t`` on its transpose plan) at the same
    ``block``; some tiles are read only in part."""
    b, plan, vec = _case(edge, tile)
    nq = edge // 128
    cpart, rpart = _partials(b, plan, vec)
    words = [int(w) for w in plan.words]
    assert any(0 < bin(w).count("1") < nq * nq for w in words)
    dssrc, dsdst = _skip_rule(plan, nq, cpart, rpart)
    plain = att_bsr.att_sums_plain(plan, cpart, rpart)
    np.testing.assert_array_equal(dssrc, plain[0].numpy())
    np.testing.assert_array_equal(dsdst, plain[1].numpy())

    rows, cols = b.rows.numpy(), b.cols.numpy()
    jblocks = jnp.asarray(b.blocks.float().numpy())
    if tile == "bf16":
        jblocks = jblocks.astype(jnp.bfloat16)
    pj = jax_plan(rows, cols, b.num_row_blocks)
    args = [jblocks] + [jnp.asarray(vec[k]) for k in
                        ("ssrc", "sdst", "m", "g", "x", "dden")]
    _, dssrc_j = jax_att._att_bwd_t(pj.t_rows, pj.t_cols, pj.t_sel,
                                    pj.t_scale, *args, edge, SLOPE,
                                    interpret=True)
    dsdst_j = jax_att._att_bwd_f(jnp.asarray(rows), jnp.asarray(cols),
                                 *args, edge, SLOPE, interpret=True)
    close(torch.from_numpy(dssrc), dssrc_j, grad=True)
    close(torch.from_numpy(dsdst), dsdst_j, grad=True)
