"""The kernel forms without a bf16-activation form of their own, on bf16
activations, against the JAX package, on the CPU.

Each takes the widened route (``ops/kernels.py``, ``widened``): the bf16
operands widened to f32 (exact), the form for the tiles' type run (its
kernel on the card, its plain version here, because the tensors lie on
the CPU), each bf16 output rounded once.  One call through each wrapper:
K2, K9 and K10 (``bsr_spmm_fwd``, ``_grouped``, ``_rowwalk``), K1 at edge
256 with the occupancy words, K8 (``diag_spmm``), K7f (``att_fwd``), K7bt's
``dx`` (``att_bwd_t``) and the score pass (``att_bwd_scores``), each
against the JAX kernel in interpret mode on the same bf16 arrays.  K4, K4ᵀ
and K5 have bf16-activation forms of their own (K4a, K4ᵀa, K5a): their
cases are ``tests/test_torch_port_bf16_dyn.py``'s.

Tolerance: within ``1e-2·max|ref|`` (the Pallas kernels round each tile's
partial into a bf16 block, and K7's cast ``pe`` to bf16 before its
product, where the route rounds the f32 total once; ROADMAP.md §3); the
outputs in the JAX kernel's type, and equal, bit for bit, to the same
wrapper on the widened operands rounded once (the route's definition).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fitgnn_tpu.ops.pallas import att_bsr as jax_att
from fitgnn_tpu.ops.pallas.bsr_dynamic import build_dyn_plan as jax_plan
from fitgnn_tpu.ops.pallas.bsr_spmm import _fwd_dispatch, bsr_spmm_acc_raw
from fitgnn_tpu.ops.pallas.bsr_spmm import build_bsr as jax_build_bsr
from fitgnn_tpu.ops.pallas.diag_spmm import diag_spmm_raw

from fitgnn_tpu_torch.ops import att_bsr
from fitgnn_tpu_torch.ops.bsr_dynamic import build_dyn_plan
from fitgnn_tpu_torch.ops.bsr_spmm import (build_bsr, bsr_spmm_acc,
                                           bsr_spmm_raw)
from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm

from test_torch_port_bf16 import sorted_coo
from test_torch_port_bf16_act import bf, bf16_array, close
from test_torch_port_fused import SLOPE, _tile_inputs

torch.set_num_threads(1)

BF16 = torch.bfloat16
JBF16 = jnp.bfloat16
N = 512


def _j(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


def _widened_equal(got, fn, *acts):
    """``got`` is ``fn`` on the widened operands, rounded once."""
    ref = fn(*(a.float() for a in acts))
    assert torch.equal(got, ref.to(got.dtype))


def _static(form):
    """K2, K9, K10 or K1@256: both packages' operators and a bf16 x."""
    layout = {"K2": {}, "K9": dict(group=2), "K10": dict(rowwalk=True),
              "K1@256": dict(block=256)}[form]
    s, r, w = sorted_coo(np.random.default_rng(11), N, 5000)
    x = bf16_array(np.random.default_rng(12), (N, 16))
    return (build_bsr(s, r, w, N, **layout), jax_build_bsr(s, r, w, N,
                                                           **layout), x)


def run_static(form):
    bt, bj, x = _static(form)
    if form == "K1@256":
        assert bt.quad_bits is not None                 # the words walk
        init = bf16_array(np.random.default_rng(13), (N, 16))
        got = bsr_spmm_acc(bt, bf(x), bf(init))
        ref = bsr_spmm_acc_raw(bj, _j(x, JBF16), _j(init, JBF16))
        _widened_equal(got, lambda a, b: bsr_spmm_acc(bt, a, b), bf(x),
                       bf(init))
        return got, ref
    got = bsr_spmm_raw(bt, bf(x))
    _widened_equal(got, lambda a: bsr_spmm_raw(bt, a), bf(x))
    return got, _fwd_dispatch(bj, _j(x, JBF16))


def run_k8():
    rng = np.random.default_rng(14)
    blocks = (rng.standard_normal((4, 128, 128))
              * (rng.random((4, 128, 128)) < 0.1)).astype(np.float32)
    x, init = bf16_array(rng, (N, 16)), bf16_array(rng, (N, 16))
    bt = torch.from_numpy(blocks)
    got = diag_spmm(bt, bf(x), 2, transpose=True, init=bf(init))
    _widened_equal(got, lambda a, b: diag_spmm(bt, a, 2, True, b), bf(x),
                   bf(init))
    return got, diag_spmm_raw(_j(blocks), _j(x, JBF16), 2, transpose=True,
                              init=_j(init, JBF16))


def run_k7(form):
    d = _tile_inputs(16, 16)
    plan = build_dyn_plan(d["rows"], d["cols"], d["nb"])
    pj = jax_plan(d["rows"], d["cols"], d["nb"])
    d["x"] = bf16_array(np.random.default_rng(16), d["x"].shape)
    d["g"] = bf16_array(np.random.default_rng(17), d["g"].shape)
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()
         if k != "nb"}
    x, g = bf(d["x"]), bf(d["g"])
    vec = {k: _j(d[k]) for k in ("blocks", "ssrc", "sdst", "m", "dden")}
    if form == "K7f":
        num, den = att_bsr.att_fwd(p["rows"], p["cols"], plan, p["blocks"],
                                   p["ssrc"], p["sdst"], p["m"], x, SLOPE)
        num_j, den_j = jax_att._att_fwd(
            _j(d["rows"]), _j(d["cols"]), vec["blocks"], vec["ssrc"],
            vec["sdst"], vec["m"], _j(d["x"], JBF16), 128, SLOPE,
            interpret=True)
        assert den.dtype == torch.float32
        close(den, den_j, 1e-5)
        return num, num_j
    args = (plan, p["blocks"], p["ssrc"], p["sdst"], p["m"])
    dx_j, dssrc_j = jax_att._att_bwd_t(
        pj.t_rows, pj.t_cols, pj.t_sel, pj.t_scale, vec["blocks"],
        vec["ssrc"], vec["sdst"], vec["m"], _j(d["g"], JBF16),
        _j(d["x"], JBF16), vec["dden"], 128, SLOPE, interpret=True)
    if form == "K7bt":
        dx, dssrc = att_bsr.att_bwd_t(*args, g, x, p["dden"], SLOPE)
        assert dssrc.dtype == torch.float32
        close(dssrc, dssrc_j)
        return dx, dx_j
    dssrc, dsdst = att_bsr.att_bwd_scores(p["rows"], p["cols"], *args, g, x,
                                          p["dden"], SLOPE)
    dsdst_j = jax_att._att_bwd_f(
        _j(d["rows"]), _j(d["cols"]), vec["blocks"], vec["ssrc"],
        vec["sdst"], vec["m"], _j(d["g"], JBF16), _j(d["x"], JBF16),
        vec["dden"], 128, SLOPE, interpret=True)
    assert dssrc.dtype == torch.float32
    close(dssrc, dssrc_j)
    return dsdst, dsdst_j


FORMS = {"K2": lambda: run_static("K2"), "K9": lambda: run_static("K9"),
         "K10": lambda: run_static("K10"),
         "K1@256": lambda: run_static("K1@256"), "K8": run_k8,
         "K7f": lambda: run_k7("K7f"),
         "K7bt": lambda: run_k7("K7bt"), "K7s": lambda: run_k7("K7s")}


@pytest.mark.parametrize("form", list(FORMS))
def test_widened_form_matches_jax(form):
    got, ref = FORMS[form]()
    assert got.dtype == (torch.float32 if ref.dtype == jnp.float32
                         else BF16)
    close(got, ref)
