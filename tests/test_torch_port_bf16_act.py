"""The kernels' bf16-activation forms against the JAX package, on the CPU.

The JAX conv stack's ``dtype=bfloat16`` hands bf16 activations to every
Pallas kernel.  The port has three native forms for them (K1a and K1bfa,
K1 on f32 and bf16 tiles; K3a, the straggler sum, which K3w and K6 share;
K11a, the dropout) and takes a widened route for the rest
(``tests/test_torch_port_bf16_widened.py``).  The same seeded numpy inputs,
rounded to bf16, go through each kernel-holding function of both
packages: the JAX kernels in interpret mode, the port's wrappers on their
plain versions because the tensors lie on the CPU.

Tolerances: each output is bf16 and lies within ``1e-2·max|ref|`` of the
JAX package's (the Pallas kernels round each tile's or chunk's partial
into a bf16 block and the port rounds each f32 sum once: a few bf16 steps
of 2⁻⁸ apart at most).  The port's own rule is held tighter: K1's output
within one rounding (rtol 2⁻⁸) of the float64 sum, K3's equal to the
rounded sum over the weights rounded to bf16 first (the Pallas kernels
cast the selector to bf16), on inputs chosen so that the rule with the
unrounded weights gives other bf16 values; K6's ``den`` the f32 sum of
the unrounded weights (rtol 1e-5); K11a's mask the f32 form's bit for
bit, its kept values the bf16 product ``x·bf16(1/(1−rate))`` exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.pallas.bsr_spmm import build_bsr as jax_build_bsr
from fitgnn_tpu.ops.pallas.bsr_spmm import bsr_spmm_acc_raw
from fitgnn_tpu.ops.pallas.coo_segmm import build_segmm as jax_build_segmm
from fitgnn_tpu.ops.pallas.coo_segmm import segmm_spmm as jax_segmm_spmm
from fitgnn_tpu.ops.pallas.coo_segmm import \
    segmm_weighted_spmm as jax_segmm_weighted
from fitgnn_tpu.ops.pallas.coo_segmm import \
    segmm_weighted_spmm_den as jax_segmm_den

from fitgnn_tpu_torch.ops.bsr_spmm import build_bsr, bsr_spmm_acc
from fitgnn_tpu_torch.ops.coo_segmm import (build_segmm, segmm_spmm,
                                            segmm_weighted_spmm,
                                            segmm_weighted_spmm_den)
from fitgnn_tpu_torch.ops.dropout import (fused_dropout,
                                          philox_dropout_plain)
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid

from test_torch_port_bf16 import sorted_coo

torch.set_num_threads(1)

BF16 = torch.bfloat16
N = 512


def bf16_array(rng, shape, lo=None) -> np.ndarray:
    """Unit-normal values (or uniform in [lo, 2·lo)) rounded to bf16, as
    f32 numpy."""
    v = (rng.standard_normal(shape) if lo is None
         else lo * (1.0 + rng.random(shape)))
    return torch.from_numpy(v.astype(np.float32)).to(BF16).float().numpy()


def bf(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(BF16)


def close(got: torch.Tensor, ref, tol=1e-2):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    np.testing.assert_allclose(got.float().detach().numpy(), ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("tiles", ["f32", "bf16"])
def test_k1_on_bf16_activations_matches_jax(tiles, transpose):
    """K1a / K1bfa (``bsr_spmm_acc`` on bf16 ``x`` and ``init``), forward
    and on the transpose, against ``bsr_spmm_acc_raw`` on bf16 arrays."""
    s, r, w = sorted_coo(np.random.default_rng(1), N, 5000)
    bt = build_bsr(s, r, w, N, tile_dtype=BF16 if tiles == "bf16" else None)
    bj = jax_build_bsr(s, r, w, N, tile_dtype=jnp.bfloat16
                       if tiles == "bf16" else None)
    if transpose:
        bt, bj = bt.transpose, bj.transpose
    rng = np.random.default_rng(2)
    x, init = bf16_array(rng, (N, 24)), bf16_array(rng, (N, 24))
    got = bsr_spmm_acc(bt, bf(x), bf(init))
    assert got.dtype == BF16
    close(got, bsr_spmm_acc_raw(bj, jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(init, jnp.bfloat16)))
    # the port's rule: the f32 sum rounded once
    a = np.zeros((N, N))
    a[(bt.rows.long()[:, None, None] * 128 + torch.arange(128)[None, :, None]
       ).expand(-1, -1, 128).numpy(),
      (bt.cols.long()[:, None, None] * 128 + torch.arange(128)[None, None, :]
       ).expand(-1, 128, -1).numpy()] += bt.blocks.double().numpy()
    exact = init.astype(np.float64) + a @ x.astype(np.float64)
    np.testing.assert_allclose(got.double().numpy(), exact, rtol=2 ** -8,
                               atol=1e-30)


def _few_edge_csr(rng, n):
    """Up to three edges a row, weights in [0.5, 1) that are not bf16
    values: the f32 sums of the exact bf16 × bf16 products are exact."""
    counts = rng.integers(0, 4, n)
    r = np.repeat(np.arange(n), counts)
    s = rng.integers(0, n, len(r))
    w = (0.5 + 0.5 * rng.random(len(r))).astype(np.float32)
    w = np.where(torch.from_numpy(w).to(BF16).float().numpy() == w,
                 w + np.float32(2 ** -12), w).astype(np.float32)
    return s, r, w


def test_k3_rounds_each_weight_to_bf16_first():
    """K3a's rule, as the Pallas kernel casts its selector: each weight
    rounded to bf16 before its product; the result differs from the rule
    with the unrounded weights, and matches the JAX package's."""
    rng = np.random.default_rng(3)
    s, r, w = _few_edge_csr(rng, N)
    x = bf16_array(rng, (N, 16), lo=1.0)
    got = segmm_spmm(build_segmm(s, r, w, N), bf(x))
    assert got.dtype == BF16

    def rule(weights):
        out = np.zeros((N, 16))
        np.add.at(out, r, weights[:, None].astype(np.float64) * x[s])
        return torch.from_numpy(out).to(BF16)

    w_r = torch.from_numpy(w).to(BF16).float().numpy()
    assert torch.equal(got, rule(w_r))
    assert not torch.equal(got, rule(w))
    close(got, jax_segmm_spmm(jax_build_segmm(s, r, w, N),
                              jnp.asarray(x, jnp.bfloat16)))


def _straggler_pair(seed, semantics):
    s, r, w = sorted_coo(np.random.default_rng(seed), N, 3000, internal=0.0)
    kw = dict(min_block_edges=10 ** 9, use_segmm=True, semantics=semantics)
    return build_hybrid(s, r, w, N, **kw), jax_build_hybrid(s, r, w, N, **kw)


@pytest.mark.parametrize("direction", ["forward", "transpose"])
def test_k3_on_bf16_activations_matches_jax(direction):
    """K3a on the straggler CSR of both directions (the hybrid chain's K3
    forward and in the backward)."""
    ht, hj = _straggler_pair(4, "gcn_norm")
    mt, mj = ((ht.segmm, hj.segmm) if direction == "forward"
              else (ht.t_segmm, hj.t_segmm))
    x = bf16_array(np.random.default_rng(5), (N, 32))
    got = segmm_spmm(mt, bf(x))
    assert got.dtype == BF16
    close(got, jax_segmm_spmm(mj, jnp.asarray(x, jnp.bfloat16)))


def test_k3w_on_bf16_activations_matches_jax():
    """K3w (GAT's straggler numerator at F ≤ 64): the forward on the CSR and
    ``dx`` on the transpose CSR with the permutation, bf16 both, and the
    f32 ``dw``."""
    ht, hj = _straggler_pair(6, "att_unit")
    rng = np.random.default_rng(7)
    e = ht.num_coo_edges
    w_e = rng.random(e).astype(np.float32)
    x = bf16_array(rng, (N, 16))
    tgt = bf16_array(rng, (N, 16))

    def loss_j(ww, xx):
        out = jax_segmm_weighted(hj.segmm, hj.t_segmm, hj.senders,
                                 hj.receivers, ww, xx)
        return jnp.sum(out.astype(jnp.float32) * tgt), out

    (_, out_j), (dw_j, dx_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(
            jnp.asarray(w_e), jnp.asarray(x, jnp.bfloat16))
    wt = torch.from_numpy(w_e).requires_grad_()
    xt = bf(x).requires_grad_()
    out = segmm_weighted_spmm(ht.segmm, ht.t_segmm, ht.senders,
                              ht.receivers, ht.t_edge_perm, wt, xt)
    (out.float() * torch.from_numpy(tgt)).sum().backward()
    assert out.dtype == xt.grad.dtype == BF16
    assert wt.grad.dtype == torch.float32
    close(out, out_j)
    close(xt.grad, dx_j)
    close(wt.grad, dw_j)


def test_k6_on_bf16_activations_matches_jax():
    """K6: the numerator in bf16 against the JAX package's, the
    denominator the f32 sum of the unrounded weights."""
    ht, hj = _straggler_pair(8, "att_unit")
    rng = np.random.default_rng(9)
    e = ht.num_coo_edges
    w_e = (0.5 + rng.random(e)).astype(np.float32)
    x = bf16_array(rng, (N, 24))
    num_j, den_j = jax_segmm_den(hj.segmm, hj.t_segmm, hj.receivers,
                                 jnp.asarray(w_e),
                                 jnp.asarray(x, jnp.bfloat16))
    num, den = segmm_weighted_spmm_den(ht.segmm, ht.t_segmm, ht.receivers,
                                       ht.t_edge_perm,
                                       torch.from_numpy(w_e), bf(x))
    assert num.dtype == BF16 and den.dtype == torch.float32
    close(num, num_j)
    exact = np.zeros(N)
    np.add.at(exact, ht.receivers.numpy(),
              w_e.astype(np.float64) * ht.weights.double().numpy())
    np.testing.assert_allclose(den.numpy(), exact, rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(den.numpy(), np.asarray(den_j), rtol=1e-5)


@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_k11_on_bf16_keeps_the_f32_mask(rate):
    """K11a's plain version: the f32 form's mask on the same seed, bit for
    bit, and each kept value the bf16 product with the bf16 scale; the
    backward regenerates the same mask."""
    rng = np.random.default_rng(10)
    x = bf16_array(rng, (N, 40), lo=0.25)           # no zero to hide a drop
    seed = torch.tensor([1234], dtype=torch.int32)
    narrow = philox_dropout_plain(bf(x), seed, rate)
    wide = philox_dropout_plain(torch.from_numpy(x), seed, rate)
    assert narrow.dtype == BF16
    assert torch.equal(narrow == 0, wide == 0)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float64).to(BF16)
    assert torch.equal(narrow, torch.where(wide == 0, 0.0, bf(x) * scale))
    xt = bf(x).requires_grad_()
    fused_dropout(xt, seed, rate).float().sum().backward()
    assert xt.grad.dtype == BF16
    assert torch.equal(xt.grad == 0, wide == 0)
