"""GAT's fused tile attention (K7) at tile edge 256 against the JAX package,
on the CPU.

The same seeded numpy inputs go through both packages, on the 256-wide
``att_unit`` operators of ``test_torch_port_gat_block.py`` (1,024 nodes,
f32 and bf16 masks, the cluster collapse with exact k 0 and 12): the plain
K7rm, K7f, K7bt (``dx`` and ``dssrc``), K7bf and ``att_bwd_scores`` against
the JAX package's ``att_rowmax``, ``_att_fwd``, ``_att_bwd_t`` and
``_att_bwd_f`` at ``block=256``; the score pass's partials in their
(K, nq·E) layout and ``att_sums_plain`` on them; ``tile_gat_attention``
under ``FUSED_TILES=1`` alone, with ``SEGMM_DEN=1`` and with
``GLOBAL_MAX=0`` (forward and the gradients in ``score_src``,
``score_dst`` and ``h``); one fused GAT ``gc_train_step``; and every K7
wrapper's refusal of a 192-wide tile.  The JAX Pallas kernels run in
interpret mode (its module reads ``_FUSED_TILES`` and ``_GLOBAL_MAX`` at
import, so the tests set them on the module); the port's wrappers take
their plain versions because the tensors lie on the CPU.

Tolerance: forward rtol 1e-4 and atol 1e-4·max|ref|, gradients (and the
score gradients) rtol 1e-3 and atol 1e-3·max|ref| (f32 sums and exps in
another order); K7rm's max bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.ops import tile_gat as jax_tile_gat_mod
from fitgnn_tpu.ops.pallas import att_bsr as jax_att
from fitgnn_tpu.ops.pallas.bsr_dynamic import build_dyn_plan as jax_plan
from fitgnn_tpu.train import losses as jax_losses

from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.ops import att_bsr
from fitgnn_tpu_torch.ops.bsr_dynamic import build_dyn_plan
from fitgnn_tpu_torch.ops.tile_gat import tile_gat_attention
from fitgnn_tpu_torch.train import steps

from test_torch_port_fused import switch
from test_torch_port_gat_block import (E, N, SLOPE, _gat_graphs, close,
                                       operators)

torch.set_num_threads(1)

NB = N // E
# the K7 wrappers' launch counters: none moves on the CPU
COUNTED = (att_bsr.att_rowmax, att_bsr.att_fwd, att_bsr.att_bwd_t,
           att_bsr.att_bwd_scores)


def launches():
    return ([(f.launches, f.launches_bf16) for f in COUNTED],
            att_bsr.att_sums.launches)


def _inputs(seed, feat, bf16=False):
    """A sorted list of 256-wide presence tiles covering every tile row
    whose tile column 2 is never used (a scale-0 filler slot in the
    transpose plan); ~5% fill, quadrant (0, 1) of every tile empty, and
    nodes 100-119 and 968-987 (a half of tile rows 0 and 3) without an
    entry, so their exact max is −1e30; ``m`` is that max plus a margin
    elsewhere (a valid stabilizer); scores, features, cotangents and
    ``dden`` unit normal."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.concatenate([np.arange(NB), rng.integers(0, NB, 6)]))
    cols = rng.choice([0, 1, 3], len(rows))
    blocks = (rng.random((len(rows), E, E)) < 0.05).astype(np.float32)
    blocks[:, :128, 128:] = 0.0
    blocks[rows == 0, 100:120, :] = 0.0
    blocks[rows == 3, 200:220, :] = 0.0
    ssrc = rng.standard_normal(N).astype(np.float32)
    sdst = rng.standard_normal(N).astype(np.float32)
    raw = sdst.reshape(NB, E)[rows][:, :, None] \
        + ssrc.reshape(NB, E)[cols][:, None, :]
    e = np.where(blocks != 0, np.where(raw >= 0, raw, SLOPE * raw), -1e30)
    m = np.full((NB, E), -1e30, np.float32)
    np.maximum.at(m, rows, e.max(axis=2))
    m = m.reshape(N)
    m = np.where(m > -1e29, m + rng.random(N).astype(np.float32), m)
    d = dict(rows=rows.astype(np.int32), cols=cols.astype(np.int32),
             blocks=blocks, ssrc=ssrc, sdst=sdst, m=m.astype(np.float32),
             x=rng.standard_normal((N, feat)).astype(np.float32),
             g=rng.standard_normal((N, feat)).astype(np.float32),
             dden=rng.standard_normal(N).astype(np.float32))
    port = {k: torch.from_numpy(v) for k, v in d.items()}
    jaxd = {k: jnp.asarray(v) for k, v in d.items()}
    if bf16:
        port["blocks"] = port["blocks"].to(torch.bfloat16)
        jaxd["blocks"] = jaxd["blocks"].astype(jnp.bfloat16)
    return (build_dyn_plan(rows, cols, NB), jax_plan(rows, cols, NB), port,
            jaxd)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_att_rowmax_block256_matches_jax(bf16):
    """K7rm at 256: the masked row max bit for bit, −1e30 on the nodes
    without an entry."""
    plan, _, p, j = _inputs(1, 8, bf16)
    ref = jax_att.att_rowmax(j["rows"], j["cols"], j["blocks"], j["ssrc"],
                             j["sdst"], E, SLOPE, interpret=True)
    before = launches()
    got = att_bsr.att_rowmax(p["rows"], p["cols"], plan, p["blocks"],
                             p["ssrc"], p["sdst"], SLOPE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[100:120] == -1e30).all() and (got[968:988] == -1e30).all()
    assert launches() == before


@pytest.mark.parametrize("feat", [16, 128])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["K7f", "K7bt", "K7bf", "scores"])
def test_k7_block256_match_jax(kernel, bf16, feat):
    """K7f (``num``, ``den``), K7bt (``dx`` and ``dssrc`` on the transpose
    plan with its filler slot), K7bf (``dsdst``) and ``att_bwd_scores``
    (both score gradients from one pass) on 256-wide masks."""
    plan, pj, p, j = _inputs(feat + 2 * bf16, feat, bf16)
    before = launches()
    vec = [j[k] for k in ("blocks", "ssrc", "sdst", "m", "g", "x", "dden")]
    bwd = (plan, p["blocks"], p["ssrc"], p["sdst"], p["m"], p["g"], p["x"],
           p["dden"], SLOPE)
    if kernel == "K7f":
        num_j, den_j = jax_att._att_fwd(
            j["rows"], j["cols"], *(j[k] for k in ("blocks", "ssrc", "sdst",
                                                   "m", "x")),
            E, SLOPE, interpret=True)
        num, den = att_bsr.att_fwd(p["rows"], p["cols"], plan, p["blocks"],
                                   p["ssrc"], p["sdst"], p["m"], p["x"],
                                   SLOPE)
        close(num, num_j)
        close(den, den_j)
        assert not num[100:120].any() and not den[968:988].any()
    elif kernel == "K7bt":
        assert 0 in np.asarray(pj.t_scale)                  # a filler slot
        dx_j, dssrc_j = jax_att._att_bwd_t(
            pj.t_rows, pj.t_cols, pj.t_sel, pj.t_scale, *vec, E, SLOPE,
            interpret=True)
        dx, dssrc = att_bsr.att_bwd_t(*bwd)
        close(dx, dx_j, grad=True)
        close(dssrc, dssrc_j, grad=True)
        assert not dx[2 * E:3 * E].any()         # the filler's tile column
    elif kernel == "K7bf":
        ref = jax_att._att_bwd_f(j["rows"], j["cols"], *vec, E, SLOPE,
                                 interpret=True)
        got = att_bsr.att_bwd_f(p["rows"], p["cols"], *bwd)
        close(got, ref, grad=True)
        assert not got[100:120].any()
    else:
        _, dssrc_j = jax_att._att_bwd_t(pj.t_rows, pj.t_cols, pj.t_sel,
                                        pj.t_scale, *vec, E, SLOPE,
                                        interpret=True)
        dsdst_j = jax_att._att_bwd_f(j["rows"], j["cols"], *vec, E, SLOPE,
                                     interpret=True)
        dssrc, dsdst = att_bsr.att_bwd_scores(p["rows"], p["cols"], *bwd)
        close(dssrc, dssrc_j, grad=True)
        close(dsdst, dsdst_j, grad=True)
    assert launches() == before


def test_score_partials_block256_layout_and_sums_match_jax():
    """The score pass's partials at 256, (K, 2·256): ``rpart[k, 256 qj +
    128 qi + i]`` row i's sum of ``d_raw`` over quadrant (qi, qj)'s
    columns, ``cpart[k, 256 qi + 128 qj + j]`` column j's over its rows
    (each against ``d_raw`` summed by quadrant in numpy); ``att_sums`` on
    them against the JAX package's ``dssrc`` and ``dsdst``."""
    plan, pj, p, j = _inputs(5, 24)
    args = (p["rows"], p["cols"], plan, p["blocks"], p["ssrc"], p["sdst"],
            p["m"], p["g"], p["x"], p["dden"], SLOPE)
    cpart, rpart = att_bsr.att_scores_plain(*args)
    k = len(p["rows"])
    assert cpart.shape == rpart.shape == (k, 2 * E)
    # d_raw of every tile entry from the definition, in float64
    rows, cols = p["rows"].long(), p["cols"].long()
    sd = p["sdst"].double().reshape(NB, E)[rows][:, :, None]
    raw = sd + p["ssrc"].double().reshape(NB, E)[cols][:, None, :]
    mask = p["blocks"] != 0
    pe = torch.where(mask, torch.exp(torch.where(raw >= 0, raw, SLOPE * raw)
                     - p["m"].double().reshape(NB, E)[rows][:, :, None]),
                     0.0)
    gx = torch.bmm(p["g"].double().reshape(NB, E, -1)[rows],
                   p["x"].double().reshape(NB, E, -1)[cols].transpose(1, 2))
    d_raw = pe * (gx + p["dden"].double().reshape(NB, E)[rows][:, :, None])
    d_raw = torch.where(raw >= 0, d_raw, SLOPE * d_raw)
    quads = d_raw.reshape(k, 2, 128, 2, 128)            # [k, qi, i, qj, j]
    r_ref = quads.sum(4).permute(0, 3, 1, 2).reshape(k, 2 * E)
    c_ref = quads.sum(2).reshape(k, 2 * E)
    close(rpart, r_ref.numpy(), grad=True)
    close(cpart, c_ref.numpy(), grad=True)
    vec = [j[k_] for k_ in ("blocks", "ssrc", "sdst", "m", "g", "x", "dden")]
    _, dssrc_j = jax_att._att_bwd_t(pj.t_rows, pj.t_cols, pj.t_sel,
                                    pj.t_scale, *vec, E, SLOPE,
                                    interpret=True)
    dsdst_j = jax_att._att_bwd_f(j["rows"], j["cols"], *vec, E, SLOPE,
                                 interpret=True)
    before = launches()
    dssrc, dsdst = att_bsr.att_sums(plan, cpart, rpart)
    close(dssrc, dssrc_j, grad=True)
    close(dsdst, dsdst_j, grad=True)
    assert not dssrc[2 * E:3 * E].any()          # no tile in column 2
    assert launches() == before


# ---- tile_gat_attention and a fused GAT step at 256 -------------------------

# the JAX package's fused switches (test_torch_port_fused.SWITCHES)
MODES = {"tiles": "fused", "segmm_den": "fused_segmm_den",
         "exact": "fused_exact_max"}


@pytest.mark.parametrize("case", ["f32", "bf16", "cluster", "cluster_exact"])
@pytest.mark.parametrize("mode", list(MODES))
def test_fused_tile_gat_attention_block256_matches_jax(monkeypatch, mode,
                                                       case):
    """``tile_gat_attention`` on the 256-wide operator through K7's plain
    versions, F = 32: the output and the gradients in ``score_src``,
    ``score_dst`` and ``h`` (independent leaves)."""
    switch(monkeypatch, MODES[mode])
    ht, hj = operators(case)
    rng = np.random.default_rng(31)
    feat = 32
    h = rng.standard_normal((N, feat)).astype(np.float32)
    ss, sd = (rng.standard_normal(N).astype(np.float32) for _ in range(2))
    tgt = rng.standard_normal((N, feat)).astype(np.float32)

    def loss_j(s_, d_, h_):
        out = jax_tile_gat_mod.tile_gat_attention(hj, s_, d_, h_, SLOPE)
        return jnp.sum((out - tgt) ** 2), out

    (_, out_j), grads_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(ss), jnp.asarray(sd), jnp.asarray(h))
    st, dt, hh = (torch.tensor(v, requires_grad=True) for v in (ss, sd, h))
    before = launches()
    out = tile_gat_attention(ht, st, dt, hh, SLOPE)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    close(out, out_j)
    for got, ref in zip((st.grad, dt.grad, hh.grad), grads_j):
        assert torch.isfinite(got).all()
        close(got, ref, grad=True)
    assert launches() == before


@pytest.mark.parametrize("case,mode", [("f32", "segmm_den"),
                                       ("bf16", "exact")])
def test_fused_gat_train_step_block256_matches_jax(monkeypatch, case, mode):
    """One ``gc_train_step`` of a 2-layer GAT (16 → 32 → 32 → 4, dropout
    off) on the 256-wide operator under ``FUSED_TILES=1``: the loss and
    every gradient against the JAX step with the same converted weights."""
    switch(monkeypatch, MODES[mode])
    gt, gj = _gat_graphs(case)
    hidden = 32
    jm = JaxNodeModel(layer_name="GATConv", hidden=hidden, num_layers=2,
                      out_dim=4, dropout_rate=0.0)
    rng = np.random.default_rng(3)

    def lin(f_in, f_out):
        return (rng.standard_normal((f_in, f_out)) / np.sqrt(f_in)).astype(
            np.float32)

    def conv(f_in):
        return {"lin": {"kernel": lin(f_in, hidden)},
                "att_src": lin(1, hidden) / np.sqrt(hidden),
                "att_dst": lin(1, hidden) / np.sqrt(hidden),
                "bias": (rng.standard_normal(hidden) / 10).astype(np.float32)}

    params = {"params": {"convs": {"GATConv_0": conv(16),
                                   "GATConv_1": conv(hidden)},
                         "head": {"kernel": lin(hidden, 4),
                                  "bias": np.zeros(4, np.float32)}}}

    def loss_j(p_):
        out = jm.apply(p_, gj.x, gj, train=True)
        return jax_losses.masked_nll(out, gj.y, gj.train_mask)

    loss_ref, grads = jax.value_and_grad(loss_j)(params)
    model = NodeModel("GATConv", 16, hidden, 2, 4, dropout_rate=0.0)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, params)))
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    before = launches()
    loss = steps.gc_train_step(model, opt, gt, gt.y, gt.train_mask,
                               torch.Generator().manual_seed(7),
                               "classification")
    close(loss, loss_ref)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p_ in model.named_parameters():
        assert torch.isfinite(p_.grad).all(), name
        close(p_.grad, ref[name], grad=True)
    assert launches() == before


# ---- refusals ---------------------------------------------------------------

@pytest.mark.parametrize("wrapper", ["att_rowmax", "att_fwd", "att_bwd_t",
                                     "att_bwd_f", "att_bwd_scores",
                                     "att_tiles", "att_sums"])
def test_k7_wrappers_refuse_an_edge_off_128(wrapper):
    """Tiles of edge 192 (and partials of a 192-wide tile) raise
    ``ValueError`` in every K7 wrapper, on the CPU too, as K4, K4ᵀ and
    K5's wrappers and ``build_hybrid`` refuse such an edge."""
    rows = torch.tensor([0, 1], dtype=torch.int32)
    cols = torch.tensor([1, 0], dtype=torch.int32)
    plan = build_dyn_plan(rows.numpy(), cols.numpy(), 2)
    blocks = torch.ones((2, 192, 192))
    v = torch.zeros(384)
    x = torch.ones((384, 8))
    bwd = (plan, blocks, v, v, v, x, x, v, SLOPE)
    calls = {
        "att_rowmax": lambda: att_bsr.att_rowmax(rows, cols, plan, blocks, v,
                                                 v, SLOPE),
        "att_fwd": lambda: att_bsr.att_fwd(rows, cols, plan, blocks, v, v,
                                           v, x, SLOPE),
        "att_bwd_t": lambda: att_bsr.att_bwd_t(*bwd),
        "att_bwd_f": lambda: att_bsr.att_bwd_f(rows, cols, *bwd),
        "att_bwd_scores": lambda: att_bsr.att_bwd_scores(rows, cols, *bwd),
        "att_tiles": lambda: att_bsr.att_tiles(SLOPE, rows, cols, plan,
                                               blocks, v, v, v, x),
        "att_sums": lambda: att_bsr.att_sums(plan, torch.zeros((2, 192)),
                                             torch.zeros((2, 192)))}
    with pytest.raises(ValueError, match="multiple of 128"):
        calls[wrapper]()
