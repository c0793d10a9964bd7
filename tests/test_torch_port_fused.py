"""The port's fused tile attention (K7) and straggler sum with its softmax
denominator (K6) against the JAX package, on the CPU.

The same numpy inputs, made from seeds, go through the JAX function and its
counterpart in the port.  The JAX Pallas kernels run in interpret mode and
its branches are switched by setting ``fitgnn_tpu.ops.tile_gat``'s module
flags; the port reads the same switches from the environment.  The port's
wrappers take their plain versions because the tensors lie on the CPU.
Tolerances: values within rtol 1e-4 and atol 1e-5·max(1, max|ref|),
gradients within rtol 1e-4 and atol 1e-4·max(1, max|ref|) (f32 sums and
exps taken in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.data.synthetic import sbm_graph
from fitgnn_tpu.graph.optimize import \
    build_optimized_graph as jax_build_optimized_graph
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.models.layers import GATConv as JaxGATConv
from fitgnn_tpu.ops import tile_gat as jax_tile_gat_mod
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.pallas import att_bsr as jax_att
from fitgnn_tpu.ops.pallas.bsr_dynamic import build_dyn_plan as jax_plan
from fitgnn_tpu.ops.pallas.coo_segmm import \
    segmm_weighted_spmm_den as jax_segmm_den
from fitgnn_tpu.train import losses as jax_losses

from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.layers import GATConv
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.ops import att_bsr, tile_gat
from fitgnn_tpu_torch.ops.bsr_dynamic import build_dyn_plan
from fitgnn_tpu_torch.ops.coo_segmm import (segmm_weighted_den_raw,
                                            segmm_weighted_raw,
                                            segmm_weighted_spmm_den)
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
from fitgnn_tpu_torch.ops.tile_gat import tile_gat_attention
from fitgnn_tpu_torch.train import steps

torch.set_num_threads(1)

SLOPE = 0.2


def close(got, ref, grad=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=(1e-4 if grad else 1e-5) * scale)


def t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def no_launches():
    return (att_bsr.att_rowmax.launches == att_bsr.att_fwd.launches
            == att_bsr.att_bwd_t.launches == att_bsr.att_bwd_scores.launches
            == att_bsr.att_sums.launches
            == segmm_weighted_den_raw.launches == 0)


# ---- the four K7 functions -------------------------------------------------

def _tile_inputs(seed, feat, nb=5):
    """A sorted tile list covering every block row whose block column 3 is
    never used (the transpose plan needs a filler there); sparse presence
    tiles in which nodes 0-9 have no entry, so their ``m`` is −1e30; ``m``
    elsewhere is the exact row max plus a margin (a valid stabilizer)."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.concatenate([np.arange(nb), rng.integers(0, nb, 6)]))
    cols = rng.permutation(np.resize([0, 1, 2, 4], len(rows)))
    blocks = (rng.random((len(rows), 128, 128)) < 0.08).astype(np.float32)
    blocks[rows == 0, :10, :] = 0.0
    n = nb * 128
    ssrc = rng.standard_normal(n).astype(np.float32)
    sdst = rng.standard_normal(n).astype(np.float32)
    raw = sdst.reshape(nb, 128)[rows][:, :, None] + \
        ssrc.reshape(nb, 128)[cols][:, None, :]
    e = np.where(blocks != 0, np.where(raw >= 0, raw, SLOPE * raw), -1e30)
    m = np.full((nb, 128), -1e30, np.float32)
    np.maximum.at(m, rows, e.max(axis=2))
    m = m.reshape(n)
    m = np.where(m > -1e29, m + rng.random(n).astype(np.float32), m)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    g = rng.standard_normal((n, feat)).astype(np.float32)
    dden = rng.standard_normal(n).astype(np.float32)
    return dict(rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                nb=nb, blocks=blocks, ssrc=ssrc, sdst=sdst,
                m=m.astype(np.float32), x=x, g=g, dden=dden)


def _port(d):
    plan = build_dyn_plan(d["rows"], d["cols"], d["nb"])
    return plan, {k: t(v) for k, v in d.items() if k != "nb"}


def test_att_rowmax_matches_jax():
    d = _tile_inputs(0, 8)
    plan, p = _port(d)
    ref = jax_att.att_rowmax(jnp.asarray(d["rows"]), jnp.asarray(d["cols"]),
                             jnp.asarray(d["blocks"]), jnp.asarray(d["ssrc"]),
                             jnp.asarray(d["sdst"]), 128, SLOPE,
                             interpret=True)
    got = att_bsr.att_rowmax(p["rows"], p["cols"], plan, p["blocks"],
                             p["ssrc"], p["sdst"], SLOPE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[:10] == -1e30).all() and (got[10:] > -1e29).all()
    assert no_launches()


@pytest.mark.parametrize("feat", [16, 24])
def test_att_fwd_matches_jax(feat):
    d = _tile_inputs(feat, feat)
    plan, p = _port(d)
    num_j, den_j = jax_att._att_fwd(
        *(jnp.asarray(d[k]) for k in ("rows", "cols", "blocks", "ssrc",
                                       "sdst", "m", "x")), 128, SLOPE,
        interpret=True)
    num, den = att_bsr.att_fwd(p["rows"], p["cols"], plan, p["blocks"],
                               p["ssrc"], p["sdst"], p["m"], p["x"], SLOPE)
    close(num, num_j)
    close(den, den_j)
    assert not num[:10].any() and not den[:10].any()
    assert no_launches()


@pytest.mark.parametrize("feat", [16, 24])
def test_att_bwd_t_matches_jax(feat):
    d = _tile_inputs(feat + 1, feat)
    plan, p = _port(d)
    pj = jax_plan(d["rows"], d["cols"], d["nb"])
    assert 0 in np.asarray(pj.t_scale)                  # a filler slot
    dx_j, dssrc_j = jax_att._att_bwd_t(
        pj.t_rows, pj.t_cols, pj.t_sel, pj.t_scale,
        *(jnp.asarray(d[k]) for k in ("blocks", "ssrc", "sdst", "m", "g", "x",
                                       "dden")), 128, SLOPE, interpret=True)
    args = (plan, p["blocks"], p["ssrc"], p["sdst"], p["m"], p["g"], p["x"],
            p["dden"], SLOPE)
    dx, dssrc = att_bsr.att_bwd_t(*args)
    close(dx, dx_j, grad=True)
    close(dssrc, dssrc_j, grad=True)
    assert not dx[3 * 128:4 * 128].any()                # the filler's block
    none, dssrc2 = att_bsr.att_bwd_t(*args, need_dx=False)
    assert none is None and torch.equal(dssrc2, dssrc)
    dx2, none = att_bsr.att_bwd_t(*args, need_dssrc=False)
    assert none is None and torch.equal(dx2, dx)
    assert no_launches()


@pytest.mark.parametrize("feat", [16, 24])
def test_att_bwd_f_matches_jax(feat):
    d = _tile_inputs(feat + 2, feat)
    plan, p = _port(d)
    ref = jax_att._att_bwd_f(
        *(jnp.asarray(d[k]) for k in ("rows", "cols", "blocks", "ssrc",
                                       "sdst", "m", "g", "x", "dden")),
        128, SLOPE, interpret=True)
    got = att_bsr.att_bwd_f(p["rows"], p["cols"], plan, p["blocks"],
                            p["ssrc"], p["sdst"], p["m"], p["g"], p["x"],
                            p["dden"], SLOPE)
    close(got, ref, grad=True)
    assert no_launches()


@pytest.mark.parametrize("feat", [16, 24])
def test_att_bwd_scores_matches_jax(feat):
    """Both score gradients from one call, and the decomposition the card
    computes (each forward tile's column and row partials, summed over the
    transpose plan and the forward walk by ``att_sums``), against the JAX
    package's two kernels."""
    d = _tile_inputs(feat + 3, feat)
    plan, p = _port(d)
    pj = jax_plan(d["rows"], d["cols"], d["nb"])
    vec = [jnp.asarray(d[k]) for k in ("blocks", "ssrc", "sdst", "m", "g",
                                       "x", "dden")]
    _, dssrc_j = jax_att._att_bwd_t(pj.t_rows, pj.t_cols, pj.t_sel,
                                    pj.t_scale, *vec, 128, SLOPE,
                                    interpret=True)
    dsdst_j = jax_att._att_bwd_f(jnp.asarray(d["rows"]),
                                 jnp.asarray(d["cols"]), *vec, 128, SLOPE,
                                 interpret=True)
    args = (p["rows"], p["cols"], plan, p["blocks"], p["ssrc"], p["sdst"],
            p["m"], p["g"], p["x"], p["dden"], SLOPE)
    dssrc, dsdst = att_bsr.att_bwd_scores(*args)
    close(dssrc, dssrc_j, grad=True)
    close(dsdst, dsdst_j, grad=True)
    cpart, rpart = att_bsr.att_scores_plain(*args)
    assert cpart.shape == rpart.shape == (len(d["rows"]), 128)
    dssrc2, dsdst2 = att_bsr.att_sums(plan, cpart, rpart)
    close(dssrc2, dssrc_j, grad=True)
    close(dsdst2, dsdst_j, grad=True)
    assert not dsdst[:10].any()                         # rows without edges
    assert no_launches()


@pytest.mark.parametrize("x_grad,use_den", [(True, True), (False, True),
                                            (True, False)])
def test_att_tiles_matches_jax(x_grad, use_den):
    """Values and the gradients in ``ssrc``, ``sdst`` and ``x``; without
    ``x``'s gradient the backward still gives both score gradients, and a
    loss that ignores ``den`` sends no cotangent for it."""
    d = _tile_inputs(3, 16)
    plan, p = _port(d)
    pj = jax_plan(d["rows"], d["cols"], d["nb"])
    rng = np.random.default_rng(4)
    tnum = rng.standard_normal(d["x"].shape).astype(np.float32)
    tden = rng.standard_normal(d["ssrc"].shape).astype(np.float32)

    def loss_j(ss, sd, xx):
        num, den = jax_att.att_tiles(128, SLOPE, jnp.asarray(d["rows"]),
                                     jnp.asarray(d["cols"]), pj,
                                     jnp.asarray(d["blocks"]), ss, sd,
                                     jnp.asarray(d["m"]), xx)
        loss = jnp.sum((num - tnum) ** 2)
        return (loss + jnp.sum(den * tden) if use_den else loss), (num, den)

    argnums = (0, 1, 2) if x_grad else (0, 1)
    (_, (num_j, den_j)), grads_j = jax.value_and_grad(
        loss_j, argnums=argnums, has_aux=True)(
            jnp.asarray(d["ssrc"]), jnp.asarray(d["sdst"]),
            jnp.asarray(d["x"]))
    ss, sd, xx = t(d["ssrc"], True), t(d["sdst"], True), t(d["x"], x_grad)
    num, den = att_bsr.att_tiles(SLOPE, p["rows"], p["cols"], plan,
                                 p["blocks"], ss, sd, p["m"], xx)
    loss = ((num - t(tnum)) ** 2).sum()
    (loss + (den * t(tden)).sum() if use_den else loss).backward()
    close(num, num_j)
    close(den, den_j)
    for got, ref in zip((ss.grad, sd.grad, xx.grad), grads_j):
        close(got, ref, grad=True)
    assert x_grad or xx.grad is None
    assert no_launches()


# ---- K6 --------------------------------------------------------------------

def _straggler_hybrid(seed, n, keep_rows):
    """Straggler-only att_unit operators of both packages; a few edges carry
    static weight 0 (padding-like) and the receivers are only the rows
    ``keep_rows`` accepts."""
    rng = np.random.default_rng(seed)
    r = np.sort(rng.integers(0, n, 2 * n))
    r = r[keep_rows(r)]
    s = rng.integers(0, n, len(r))
    w = (rng.random(len(r)) > 0.05).astype(np.float32)
    kw = dict(min_block_edges=10 ** 9, use_segmm=True, semantics="att_unit")
    return (build_hybrid(s, r, w, n, **kw), jax_build_hybrid(s, r, w, n, **kw),
            rng)


@pytest.mark.parametrize("n,feat,empty", [
    (512, 40, (256, 384)), (512, 128, (256, 384)),
    # 16 row blocks make two selector groups on the TPU side; the first has
    # no edge, so its filler chunk comes before edge 0 (the first_slot
    # hazard of the JAX package's backward)
    (2048, 40, (0, 1024))])
def test_segmm_weighted_spmm_den_matches_jax(n, feat, empty):
    ht, hj, rng = _straggler_hybrid(
        feat + n, n, lambda r: (r < empty[0]) | (r >= empty[1]))
    e = ht.num_coo_edges
    w = rng.random(e).astype(np.float32)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    tnum = rng.standard_normal((n, feat)).astype(np.float32)
    tden = rng.standard_normal(n).astype(np.float32)

    def loss_j(ww, xx):
        num, den = jax_segmm_den(hj.segmm, hj.t_segmm, hj.receivers, ww, xx)
        return jnp.sum((num - tnum) ** 2) + jnp.sum(den * tden), (num, den)

    (_, (num_j, den_j)), (dw_j, dx_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(jnp.asarray(w), jnp.asarray(x))
    wt, xt = t(w, True), t(x, True)
    num, den = segmm_weighted_spmm_den(ht.segmm, ht.t_segmm, ht.receivers,
                                       ht.t_edge_perm, wt, xt)
    (((num - t(tnum)) ** 2).sum() + (den * t(tden)).sum()).backward()
    close(num, num_j)
    close(den, den_j)
    close(wt.grad, dw_j, grad=True)
    close(xt.grad, dx_j, grad=True)
    assert not num[empty[0]:empty[1]].any() and not den[empty[0]:empty[1]].any()
    assert segmm_weighted_den_raw.launches == segmm_weighted_raw.launches == 0


# ---- tile_gat_attention, GATConv and a train step under each switch -------

# branch name → (the JAX module flags, the port's environment)
SWITCHES = {
    "fused": ({"_FUSED_TILES": True}, {"FITGNN_GAT_FUSED_TILES": "1"}),
    "exact_max": ({"_GLOBAL_MAX": False}, {"FITGNN_GAT_GLOBAL_MAX": "0"}),
    "fused_exact_max": ({"_FUSED_TILES": True, "_GLOBAL_MAX": False},
                        {"FITGNN_GAT_FUSED_TILES": "1",
                         "FITGNN_GAT_GLOBAL_MAX": "0"}),
    "segmm_den": ({"_SEGMM_DEN": True}, {"FITGNN_GAT_SEGMM_DEN": "1"}),
    "segmm_maxf": ({"_SEGMM_MAX_F": 8}, {"FITGNN_GAT_SEGMM_MAXF": "8"}),
    "fused_segmm_den": ({"_FUSED_TILES": True, "_SEGMM_DEN": True},
                        {"FITGNN_GAT_FUSED_TILES": "1",
                         "FITGNN_GAT_SEGMM_DEN": "1"}),
}


def switch(monkeypatch, name):
    flags, env = SWITCHES[name]
    for k, v in flags.items():
        monkeypatch.setattr(jax_tile_gat_mod, k, v)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module")
def sbm():
    """A 640-node SBM graph, Leiden-ordered by both packages, on the
    att_unit hybrid operator at a 200-edge tile threshold: 14 tiles and
    about 2,000 straggler edges."""
    x, s, r, y = sbm_graph(num_nodes=640, num_classes=4, num_features=16,
                           p_in=0.1, p_out=0.01, seed=11)
    kw = dict(y=y, train_mask=np.arange(640) % 2 == 0, min_block_edges=200,
              layer_name="GATConv", seed=0)
    gt, ot = build_optimized_graph(x, s, r, **kw)
    gj, oj = jax_build_optimized_graph(x, s, r, **kw)
    np.testing.assert_array_equal(ot, oj)
    assert gt.aux.bsr is not None and gt.aux.num_coo_edges > 1000
    return gt, gj


def _attention_case(hj, ht, feat, seed, sdst_shift=None):
    """tile_gat_attention in both packages on the same seeded inputs:
    ``(out, grads)`` of JAX's, then of the port's, for ``h``, ``att_src``
    and ``score_dst``."""
    rng = np.random.default_rng(seed)
    n = ht.num_nodes
    h = rng.standard_normal((n, feat)).astype(np.float32)
    a = (rng.standard_normal(feat) / np.sqrt(feat)).astype(np.float32)
    sd = rng.standard_normal(n).astype(np.float32)
    if sdst_shift is not None:
        sd = sd + sdst_shift
    tgt = rng.standard_normal((n, feat)).astype(np.float32)

    def loss_j(hh, aa, ss):
        out = jax_tile_gat_mod.tile_gat_attention(hj, hh @ aa, ss, hh, SLOPE,
                                                  att_src=aa)
        return jnp.sum((out - tgt) ** 2), out

    (_, out_j), grads_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(h), jnp.asarray(a), jnp.asarray(sd))
    ht_, at, st = t(h, True), t(a, True), t(sd, True)
    out = tile_gat_attention(ht, ht_ @ at, st, ht_, SLOPE, att_src=at)
    ((out - t(tgt)) ** 2).sum().backward()
    return (out_j, grads_j), (out, (ht_.grad, at.grad, st.grad))


@pytest.mark.parametrize("feat", [24, 96])
@pytest.mark.parametrize("branch", ["fused", "exact_max", "fused_exact_max",
                                    "segmm_den", "segmm_maxf"])
def test_tile_gat_attention_switches_match_jax(monkeypatch, sbm, branch,
                                               feat):
    """Every switch at a width that takes K3w for the default straggler
    numerator (24) and one that takes the den-column scatter (96)."""
    switch(monkeypatch, branch)
    gt, gj = sbm
    (out_j, grads_j), (out, grads) = _attention_case(gj.aux, gt.aux, feat,
                                                     feat)
    close(out, out_j)
    for got, ref in zip(grads, grads_j):
        assert torch.isfinite(got).all()
        close(got, ref, grad=True)
    assert no_launches()


def _layer_sd(params):
    """A flax GATConv tree (parameters or gradients) by the port's names."""
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    return {"lin.weight": torch.tensor(p["lin"]["kernel"].T),
            "att_src": torch.tensor(p["att_src"]),
            "att_dst": torch.tensor(p["att_dst"]),
            "bias": torch.tensor(p["bias"])}


def _gat_params(rng, f_in, hidden):
    def a(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"params": {"lin": {"kernel": a(f_in, hidden, scale=f_in ** -.5)},
                       "att_src": a(1, hidden, scale=hidden ** -.5),
                       "att_dst": a(1, hidden, scale=hidden ** -.5),
                       "bias": a(hidden, scale=0.1)}}


@pytest.mark.parametrize("hidden", [16, 24])
@pytest.mark.parametrize("branch", ["fused", "exact_max", "fused_exact_max",
                                    "segmm_den"])
def test_gatconv_switches_match_jax(monkeypatch, sbm, branch, hidden):
    """GATConv 16 → 16 aggregates its transformed features (the wide side),
    16 → 24 the raw ones (the narrow side, no ``dx`` through the tiles)."""
    switch(monkeypatch, branch)
    gt, gj = sbm
    rng = np.random.default_rng(hidden)
    params = _gat_params(rng, 16, hidden)
    tgt = rng.standard_normal((gt.num_nodes_padded, hidden)).astype(
        np.float32)

    def loss_j(p):
        out = JaxGATConv(features=hidden).apply(p, gj.x, gj)
        return jnp.sum((out - tgt) ** 2), out

    (_, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    port = GATConv(16, hidden)
    port.load_state_dict(_layer_sd(params))
    out = port(gt.x, gt)
    ((out - t(tgt)) ** 2).sum().backward()
    close(out, out_j)
    ref = _layer_sd(grads_j)
    for name, p in port.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        close(p.grad, ref[name], grad=True)
    assert no_launches()


def test_gat_train_step_fused_segmm_den_matches_jax(monkeypatch, sbm):
    """One ``gc_train_step`` of a 2-layer GAT (16 → 24 → 24 → 4) under
    ``FUSED_TILES=1 SEGMM_DEN=1``: the loss and every gradient."""
    switch(monkeypatch, "fused_segmm_den")
    gt, gj = sbm
    jm = JaxNodeModel(layer_name="GATConv", hidden=24, num_layers=2,
                      out_dim=4, dropout_rate=0.0)
    rng = np.random.default_rng(5)
    params = {"params": {
        "convs": {"GATConv_0": _gat_params(rng, 16, 24)["params"],
                  "GATConv_1": _gat_params(rng, 24, 24)["params"]},
        "head": {"kernel": (rng.standard_normal((24, 4)) / 5).astype(
            np.float32), "bias": np.zeros(4, np.float32)}}}

    def loss_j(p):
        out = jm.apply(p, gj.x, gj, train=True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_losses.masked_nll(out, gj.y, gj.train_mask)

    loss_ref, grads = jax.value_and_grad(loss_j)(params)
    model = NodeModel("GATConv", 16, 24, 2, 4, dropout_rate=0.0)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, params)))
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    loss = steps.gc_train_step(model, opt, gt, gt.y, gt.train_mask, None,
                               "classification")
    close(loss, loss_ref)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        close(p.grad, ref[name], grad=True)
    assert no_launches()


def test_fused_tiles_fall_back_above_512(monkeypatch, sbm):
    """At F = 520 the fused branch does not apply: ``att_tiles`` is never
    called and the two-stage tiles give the default branch's result."""
    gt, _ = sbm
    rng = np.random.default_rng(6)
    n = gt.num_nodes_padded
    h = torch.from_numpy(rng.standard_normal((n, 520)).astype(np.float32))
    ss = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    sd = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    ref = tile_gat_attention(gt.aux, ss, sd, h, SLOPE)

    def refuse(*args):
        raise AssertionError("att_tiles called above F = 512")

    monkeypatch.setattr(tile_gat, "att_tiles", refuse)
    monkeypatch.setenv("FITGNN_GAT_FUSED_TILES", "1")
    assert torch.equal(tile_gat_attention(gt.aux, ss, sd, h, SLOPE), ref)


@pytest.mark.parametrize("fused", [False, True])
def test_exact_max_grads_finite_on_edgeless_rows(monkeypatch, fused):
    """600 real nodes pad to 640: the last block row mixes real and
    edgeless rows (m = −1e30 there), which must not NaN the gradients."""
    monkeypatch.setenv("FITGNN_GAT_GLOBAL_MAX", "0")
    if fused:
        monkeypatch.setenv("FITGNN_GAT_FUSED_TILES", "1")
    x, s, r, y = sbm_graph(num_nodes=600, num_classes=4, num_features=16,
                           p_in=0.1, p_out=0.01, seed=3)
    g, _ = build_optimized_graph(x, s, r, y=y, min_block_edges=8,
                                 layer_name="GATConv", seed=0)
    assert g.num_nodes_padded > 600 and g.aux.dyn_plan is not None
    layer = GATConv(16, 16)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    xt = g.x.clone().requires_grad_(True)
    (layer(xt, g) ** 2).sum().backward()
    assert torch.isfinite(xt.grad).all()
    for p in layer.parameters():
        assert torch.isfinite(p.grad).all()


@pytest.mark.parametrize("fused", [False, True])
def test_exact_max_tile_only_rows_with_very_negative_scores(monkeypatch,
                                                            fused):
    """Rows whose edges are all in tiles and whose scores all sit far below
    −88: the exact max comes from the tiles (a max that started from 0
    would underflow their denominators to 0)."""
    switch(monkeypatch, "fused_exact_max" if fused else "exact_max")
    x, s, r, y = sbm_graph(num_nodes=640, num_classes=4, num_features=16,
                           p_in=0.1, p_out=0.01, seed=11)
    kw = dict(min_block_edges=8, layer_name="GATConv", seed=0)
    gt, _ = build_optimized_graph(x, s, r, **kw)
    gj, _ = jax_build_optimized_graph(x, s, r, **kw)
    ht = gt.aux
    tile_rows = np.ones(ht.num_nodes, bool)
    tile_rows[ht.receivers.numpy()] = False             # straggler receivers
    shift = np.where(tile_rows & (np.arange(ht.num_nodes) % 3 == 0), -1000.0,
                     0.0).astype(np.float32)
    (out_j, grads_j), (out, grads) = _attention_case(gj.aux, ht, 24, 7,
                                                     sdst_shift=shift)
    close(out, out_j)
    sel = torch.from_numpy(shift < 0)
    assert out[sel].abs().sum() > 0                    # not zeroed out
    for got, ref in zip(grads, grads_j):
        assert torch.isfinite(got).all()
        close(got, ref, grad=True)
