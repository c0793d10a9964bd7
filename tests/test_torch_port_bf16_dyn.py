"""K4a, K4ᵀa and K5a, the dynamic tiles' bf16-activation forms, against the
JAX package, on the CPU.

Under the JAX conv stack's ``dtype=bfloat16`` GAT's two-stage tile path
hands K4 bf16 tiles (``pe`` in the messages' type) and bf16 ``x``, K4ᵀ the
bf16 cotangent, and K5 bf16 ``g`` and ``x`` with ``out_dtype`` bf16.  The
port's wrappers (``dyn_tiles``, ``dyn_tiles_t``, ``dyn_grad_blocks``)
launch K4a, K4ᵀa and K5a on the card; here, because the tensors lie on the
CPU, they run the plain versions, which compute what the forms compute:
the products and sums in f32 over the widened values, each output
rounded to bf16 once.  The same seeded numpy inputs, rounded to bf16, go
through ``_dyn_apply`` (both ways) and ``_dyn_grad_blocks`` in interpret
mode: at edges 128 and 256 (the plan with the tiles' occupancy words and
live list there), on a plan with a coverage filler, at a width that is a
multiple of 8 (the kernels' vector slab copy) and one that is not (the
scalar copy); then ``bsr_spmm_dyn``'s gradients against the JAX
package's custom VJP.

Tolerance: each output is bf16 and lies within ``1e-2·max|ref|`` of the
JAX package's (the Pallas kernels round each tile's product into a bf16
block and the port rounds each f32 sum once; ``ROADMAP.md`` §3).  K5a's
output is +0, bit for bit, on every quadrant the live list omits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.ops.pallas.bsr_dynamic import (_dyn_apply, _dyn_grad_blocks,
                                               bsr_spmm_dyn as jax_dyn)
from fitgnn_tpu.ops.pallas.bsr_dynamic import build_dyn_plan as jax_plan

from fitgnn_tpu_torch.ops.bsr_dynamic import (bsr_spmm_dyn, build_dyn_plan,
                                              dyn_grad_blocks,
                                              dyn_grad_blocks_plain,
                                              dyn_tiles, dyn_tiles_plain,
                                              dyn_tiles_t, dyn_tiles_t_plain)
from fitgnn_tpu_torch.ops.bsr_spmm import quad_words

from test_torch_port_bf16_act import bf, bf16_array, close

torch.set_num_threads(1)

BF16 = torch.bfloat16
JBF16 = jnp.bfloat16
NB = 4                      # block rows of the tile edge


def _j(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


def _counts():
    return tuple(getattr(fn, a) for fn in (dyn_tiles, dyn_tiles_t,
                                           dyn_grad_blocks)
                 for a in ("launches", "launches_a"))


def operands(edge, feat, seed):
    """A sorted tile list covering every block row whose block column 2 is
    never used (a scale-0 filler slot in the transpose plan); GAT's
    ``pe``-like values (positive where present, ~5% full) in bf16, at 256
    quadrant (0, 1) of every tile empty; the plan (at 256 with the tiles'
    words and live list); bf16 ``x`` and ``g``."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.concatenate([np.arange(NB), rng.integers(0, NB, 5)]))
    cols = rng.choice([0, 1, 3], len(rows))
    k = len(rows)
    vals = np.where(rng.random((k, edge, edge)) < 0.05,
                    rng.random((k, edge, edge)) + 0.1, 0.0)
    if edge > 128:
        vals[:, :128, 128:] = 0.0
    vals = torch.from_numpy(vals.astype(np.float32)).to(BF16)
    words = quad_words(vals, edge)
    plan = build_dyn_plan(rows, cols, NB, words=words, block=edge)
    assert plan.t_scale.numpy().tolist().count(0) == 1
    n = NB * edge
    return (torch.from_numpy(rows.astype(np.int32)),
            torch.from_numpy(cols.astype(np.int32)), plan, vals,
            bf16_array(rng, (n, feat)), bf16_array(rng, (n, feat)))


def _keep(plan, k, edge):
    """(K, E, E) bool: True on the 128-wide quadrants of the live list."""
    nq = edge // 128
    keep = torch.zeros(k * nq * nq, dtype=torch.bool)
    keep[plan.live.long()] = True
    return keep.reshape(k, nq, 1, nq, 1).expand(
        k, nq, 128, nq, 128).reshape(k, edge, edge)


@pytest.mark.parametrize("feat", [16, 36])
@pytest.mark.parametrize("edge", [128, 256])
@pytest.mark.parametrize("kernel", ["K4a", "K4Ta", "K5a"])
def test_bf16_dyn_forms_match_jax(kernel, edge, feat):
    """K4a (``out[rows[k]] += B[k] @ x[cols[k]]``), K4ᵀa on the transpose
    plan with its filler slot, and K5a (``dB[k] = g[rows[k]] @
    x[cols[k]]ᵀ``, at 256 on the live list) on bf16 operands."""
    rows, cols, plan, vals, x, g = operands(edge, feat, edge + feat)
    pj = jax_plan(rows.numpy(), cols.numpy(), NB)
    vj = _j(vals.float().numpy(), JBF16)
    before = _counts()
    k = len(rows)
    if kernel == "K4a":
        got = dyn_tiles(rows, cols, plan, vals, bf(x))
        plain = dyn_tiles_plain(rows, cols, plan, vals, bf(x))
        ref = _dyn_apply(vj, _j(rows.numpy()), jnp.arange(k, dtype=jnp.int32),
                         jnp.ones(k, jnp.int32), _j(cols.numpy()),
                         _j(x, JBF16), edge, trans=False, interpret=True)
    elif kernel == "K4Ta":
        got = dyn_tiles_t(plan, vals, bf(g))
        plain = dyn_tiles_t_plain(plan, vals, bf(g))
        ref = _dyn_apply(vj, pj.t_rows, pj.t_sel, pj.t_scale, pj.t_cols,
                         _j(g, JBF16), edge, trans=True, interpret=True)
        assert not got[2 * edge:3 * edge].any()        # the filler's block
    else:
        live = plan.live if edge > 128 else None
        assert (live is None) == (edge == 128)
        got = dyn_grad_blocks(rows, cols, bf(g), bf(x), edge, live)
        plain = dyn_grad_blocks_plain(rows, cols, bf(g), bf(x), edge, live)
        ref = _dyn_grad_blocks(_j(rows.numpy()), _j(cols.numpy()),
                               _j(g, JBF16), _j(x, JBF16), edge,
                               out_dtype=JBF16, interpret=True)
        assert got.shape == (k, edge, edge)
        if live is not None:
            keep = _keep(plan, k, edge)
            dead = got[~keep]
            assert not dead.any() and not dead.signbit().any()
            ref = jnp.where(jnp.asarray(keep.numpy()), ref, 0)
    assert got.dtype == plain.dtype == BF16 and ref.dtype == JBF16
    assert torch.equal(got, plain)
    close(got, ref)
    assert _counts() == before                  # the CPU launches nothing


def test_bf16_dyn_plain_rounds_the_f32_sum_once():
    """The plain versions' rule: the f32 products and sums of the widened
    operands, each output rounded to bf16 once."""
    rows, cols, plan, vals, x, g = operands(128, 36, 3)
    xt, gt = bf(x), bf(g)
    pairs = (
        (dyn_tiles_plain(rows, cols, plan, vals, xt),
         dyn_tiles_plain(rows, cols, plan, vals.float(), xt.float())),
        (dyn_tiles_t_plain(plan, vals, gt),
         dyn_tiles_t_plain(plan, vals.float(), gt.float())),
        (dyn_grad_blocks_plain(rows, cols, gt, xt),
         dyn_grad_blocks_plain(rows, cols, gt.float(), xt.float())))
    for got, wide in pairs:
        assert wide.dtype == torch.float32
        assert torch.equal(got, wide.to(BF16))


@pytest.mark.parametrize("edge", [128, 256])
def test_bsr_spmm_dyn_bf16_gradients_match_jax(edge):
    """``bsr_spmm_dyn`` on bf16 ``pe`` and ``x`` (K4a forward, K4ᵀa and
    K5a backward) against the JAX package's custom VJP on the same bf16
    arrays: the output and ``dx`` bf16 within ``1e-2·max|ref|``, ``dB``
    bf16 and within it under the tiles' non-zeros (the entries GAT's
    ``where(mask, exp(·), 0)`` reads; at 256 the port's ``dB`` is +0 on
    the quadrants the plan's live list omits)."""
    rows, cols, plan, vals, x, g = operands(edge, 16, 40 + edge)
    pj = jax_plan(rows.numpy(), cols.numpy(), NB)
    vt = vals.clone().requires_grad_()
    xt = bf(x).requires_grad_()
    out = bsr_spmm_dyn(rows, cols, plan, vt, xt)
    out.backward(bf(g))
    rj, cj = _j(rows.numpy()), _j(cols.numpy())
    ref, vjp = jax.vjp(lambda v, a: jax_dyn(rj, cj, pj, v, a),
                       _j(vals.float().numpy(), JBF16), _j(x, JBF16))
    dv, dx = vjp(_j(g, JBF16))
    assert out.dtype == xt.grad.dtype == vt.grad.dtype == BF16
    close(out, ref)
    close(xt.grad, dx)
    mask = (vals != 0).numpy()
    close(torch.from_numpy(np.where(mask, vt.grad.float().numpy(), 0.0)),
          jnp.where(jnp.asarray(mask), dv.astype(jnp.float32), 0.0))


# ---- the narrow forms on the operands of the widened route's test ---------
# (tests/test_torch_port_bf16_widened.py: its K4, K4ᵀ and K5 cases, which
# took the widened route until K4a, K4ᵀa and K5a were ported)

N = 512


def _dyn():
    """A sorted tile list whose block column 3 is unused (a filler slot in
    the transpose plan); GAT's ``pe``-like tile values in bf16."""
    rng = np.random.default_rng(15)
    nb = N // 128
    rows = np.sort(np.concatenate([np.arange(nb), rng.integers(0, nb, 5)]))
    cols = rng.choice([0, 1, 2], len(rows))
    vals = np.where(rng.random((len(rows), 128, 128)) < 0.05,
                    rng.random((len(rows), 128, 128)), 0.0)
    vals = torch.from_numpy(vals.astype(np.float32)).to(BF16)
    return (rows.astype(np.int32), cols.astype(np.int32), nb, vals,
            bf16_array(rng, (N, 16)), bf16_array(rng, (N, 16)))


def run_dyn(form):
    rows, cols, nb, vals, x, g = _dyn()
    plan, pj = build_dyn_plan(rows, cols, nb), jax_plan(rows, cols, nb)
    rt, ct = torch.from_numpy(rows), torch.from_numpy(cols)
    vj = jnp.asarray(vals.float().numpy(), JBF16)
    if form == "K4":
        k = len(rows)
        return (dyn_tiles(rt, ct, plan, vals, bf(x)),
                _dyn_apply(vj, _j(rows), jnp.arange(k, dtype=jnp.int32),
                           jnp.ones(k, jnp.int32), _j(cols), _j(x, JBF16),
                           128, trans=False, interpret=True))
    if form == "K4T":
        return (dyn_tiles_t(plan, vals, bf(g)),
                _dyn_apply(vj, pj.t_rows, pj.t_sel, pj.t_scale, pj.t_cols,
                           _j(g, JBF16), 128, trans=True, interpret=True))
    return (dyn_grad_blocks(rt, ct, bf(g), bf(x)),
            _dyn_grad_blocks(_j(rows), _j(cols), _j(g, JBF16), _j(x, JBF16),
                             128, out_dtype=JBF16, interpret=True))


@pytest.mark.parametrize("form", ["K4", "K4T", "K5"])
def test_narrow_form_matches_jax(form):
    """One call through each of K4, K4ᵀ and K5's wrappers on bf16
    operands: the output bf16 (K5's too, as the JAX kernel's
    ``out_dtype``) and within ``1e-2·max|ref|`` of the JAX kernel's."""
    got, ref = run_dyn(form)
    assert got.dtype == BF16 and ref.dtype == JBF16
    close(got, ref)
