"""bf16 adjacency tiles (``train --hybrid_bf16_tiles``) and the einsum tile
layout against the JAX package, on the CPU.

The same seeded numpy inputs go through both packages: ``build_bsr`` and
``build_hybrid`` with ``tile_dtype=bfloat16`` and ``einsum`` on every
layout; the forward and gradient of each layout; the diagonal blocks (K8);
the hybrid operator's chains; one train step of GCN, SAGE, GIN and GAT
(two-stage and ``FITGNN_GAT_FUSED_TILES=1``) on bf16 operators;
pre-aggregation; the CLI rows of ``train --baseline --hybrid_bf16_tiles``
and of the curriculum ``train --hybrid_bf16_tiles``.  The JAX Pallas
kernels run in interpret mode; the port's wrappers take their plain
versions because the tensors lie on the CPU.

The rounding rule under test, per layout: K1, K2, K9 and K8 round ``x``
(and, backward, ``g``) to bf16 and sum the exact products in f32; K10
leaves ``x`` as it is; the einsum layout rounds ``x``, each tile's product
and the sum over block rows to bf16.  ``x`` is unit normal, so almost none
of its values is a bf16, and each layout's result is also held apart from
the other rule's.

Tolerances: the f32-accumulating layouts within 1e-5·max|ref| (f32 sums in
another order); the einsum layout and the diagonal's bf16 batched matmul
within 2e-2·max|ref| (bf16 sums in another order: 8 bits of mantissa);
train steps, pre-aggregation and CLI rows as the f32 tests hold them (rtol
1e-4 and atol 1e-5·max(1, max|ref|)); arrays exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fitgnn_tpu.ops.tile_gat as jax_tile_gat_mod
import fitgnn_tpu.train.steps as jax_steps
from fitgnn_tpu.graph.optimize import \
    build_optimized_graph as jax_build_optimized_graph
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.models.models import \
    preaggregate_input as jax_preaggregate_input
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.hybrid_spmm import hybrid_spmm as jax_hybrid_spmm
from fitgnn_tpu.ops.pallas.bsr_spmm import build_bsr as jax_build_bsr
from fitgnn_tpu.ops.pallas.bsr_spmm import bsr_spmm as jax_bsr_spmm
from fitgnn_tpu.ops.pallas.bsr_spmm import bsr_spmm_acc_raw
from fitgnn_tpu.ops.pallas.diag_spmm import diag_spmm_raw
from fitgnn_tpu.train import losses as jax_losses

import fitgnn_tpu_torch.ops.hybrid_spmm as hybrid_mod
from fitgnn_tpu_torch.cli.main import main
from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import NodeModel, preaggregate_input
from fitgnn_tpu_torch.ops.bsr_spmm import (build_bsr, bsr_spmm, bsr_spmm_acc,
                                           bsr_spmm_fwd, bsr_spmm_grouped,
                                           bsr_spmm_rowwalk)
from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid, hybrid_spmm
from fitgnn_tpu_torch.ops.tile_gat import tile_gat_attention
from fitgnn_tpu_torch.train import steps

from test_torch_port_curriculum import _rows, toy  # noqa: F401 (fixture)
from test_torch_port_sage_gin import community_graph

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32_TOL = 1e-5      # f32 sums in another order
BF16_TOL = 2e-2     # bf16 sums in another order


def close(got, ref, tol=F32_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max(initial=0)))


def close_step(got, ref):
    """Train steps, losses and CLI numbers."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


def as_f32(a) -> np.ndarray:
    """A tile array of either package (bf16 or f32) as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def sorted_coo(rng, n, e, internal=0.8, skip_block=None):
    """Receiver-sorted COO, most edges in the diagonal blocks; no edge in
    block row and column ``skip_block``."""
    r = np.sort(rng.integers(0, n, e)).astype(np.int64)
    s = np.where(rng.random(e) < internal,
                 (r // 128) * 128 + rng.integers(0, 128, e),
                 rng.integers(0, n, e)).astype(np.int64)
    w = rng.random(e).astype(np.float32)
    if skip_block is not None:
        keep = (r // 128 != skip_block) & (s // 128 != skip_block)
        s, r, w = s[keep], r[keep], w[keep]
    return s, r, w


def dense(s, r, w, n):
    """The adjacency as the bf16 tiles hold it (summed in f32, then
    rounded), float64."""
    a = np.zeros((n, n), np.float32)
    np.add.at(a, (r, s), w)
    return round_bf16(a).astype(np.float64)


def round_bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(BF16).float().numpy()


# the layouts: build_bsr's flags, and whether the walk rounds x to bf16
LAYOUTS = {"gridwalk": ({}, True), "group2": (dict(group=2), True),
           "rowwalk": (dict(rowwalk=True), False),
           "einsum": (dict(einsum=True), True)}


def _bsr_pair(layout, dtype, n=768, seed=1, skip_block=2):
    s, r, w = sorted_coo(np.random.default_rng(seed), n, 5000,
                         skip_block=skip_block)
    kw = LAYOUTS[layout][0]
    bt = build_bsr(s, r, w, n, tile_dtype=dtype, **kw)
    bj = jax_build_bsr(s, r, w, n,
                       tile_dtype=jnp.bfloat16 if dtype == BF16 else None,
                       **kw)
    return bt, bj, (s, r, w)


@pytest.mark.parametrize("layout,dtype", [
    ("gridwalk", BF16), ("group2", BF16), ("rowwalk", BF16),
    ("einsum", BF16), ("einsum", None)])
def test_build_bsr_matches_jax(layout, dtype):
    """The blocks (type and values), rows, cols, row_splits and flags of
    the forward and transpose structures; block row 2 is empty (a coverage
    filler in the grid-walk and grouped layouts, none in the row walk and
    the einsum layout)."""
    bt, bj, _ = _bsr_pair(layout, dtype)
    want = dtype or torch.float32
    for mt, mj in ((bt, bj), (bt.transpose, bj.transpose)):
        assert mt.blocks.dtype == want
        assert str(mj.blocks.dtype) == str(want).split(".")[-1]
        np.testing.assert_array_equal(as_f32(mt.blocks), as_f32(mj.blocks))
        for name in ("rows", "cols", "row_splits"):
            np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                          np.asarray(getattr(mj, name)),
                                          err_msg=name)
        assert (mt.rowwalk, mt.group, mt.einsum) == (mj.rowwalk, mj.group,
                                                     mj.einsum)
    splits = bt.row_splits.numpy()
    assert (splits[3] == splits[2]) == (layout in ("rowwalk", "einsum"))


WALKS = {"gridwalk": bsr_spmm_fwd, "group2": bsr_spmm_grouped,
         "rowwalk": bsr_spmm_rowwalk}


@pytest.mark.parametrize("feat", [16, 128])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_bsr_spmm_bf16_matches_jax(layout, feat):
    """``bsr_spmm`` forward and gradient on bf16 tiles (K2, K9, K10 or the
    einsum by the layout) against the JAX ``bsr_spmm``; the JAX result
    equals the dense product under the layout's rounding rule and is held
    apart from the other rule's."""
    n = 768
    bt, bj, (s, r, w) = _bsr_pair(layout, BF16)
    rng = np.random.default_rng(feat)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    tgt = rng.standard_normal((n, feat)).astype(np.float32)
    out_j, dx_j = jax.value_and_grad(
        lambda xx: jnp.sum((jax_bsr_spmm(bj, xx) - tgt) ** 2))(jnp.asarray(x))
    ref = np.asarray(jax_bsr_spmm(bj, jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    out = bsr_spmm(bt, xt)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    tol = BF16_TOL if layout == "einsum" else F32_TOL
    close(out, ref, tol)
    close(xt.grad, dx_j, tol)
    assert not out[2 * 128:3 * 128].any()
    a = dense(s, r, w, n)
    rounds = LAYOUTS[layout][1]
    right, wrong = ((round_bf16(x), x) if rounds else (x, round_bf16(x)))
    scale = float(np.abs(ref).max())
    if layout != "einsum":
        close(ref, a @ right, F32_TOL)
        close(WALKS[layout](bt, torch.from_numpy(x)), ref)
        assert WALKS[layout].launches == WALKS[layout].launches_bf16 == 0
    assert np.abs(ref - a @ wrong).max() > 10 * F32_TOL * scale


@pytest.mark.parametrize("layout", ["gridwalk", "group2", "einsum"])
def test_bsr_spmm_acc_bf16_matches_jax(layout):
    """``init + A·x`` (K1 on the grid-walk layout, the separate add on the
    others) against ``bsr_spmm_acc_raw``."""
    bt, bj, _ = _bsr_pair(layout, BF16, n=512, seed=4, skip_block=None)
    rng = np.random.default_rng(5)
    x, init = (rng.standard_normal((512, 16)).astype(np.float32)
               for _ in range(2))
    close(bsr_spmm_acc(bt, torch.from_numpy(x), torch.from_numpy(init)),
          bsr_spmm_acc_raw(bj, jnp.asarray(x), jnp.asarray(init)),
          BF16_TOL if layout == "einsum" else F32_TOL)
    assert bsr_spmm_acc.launches == bsr_spmm_acc.launches_bf16 == 0


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
def test_diag_spmm_bf16_matches_jax(transpose, with_init):
    """K8 on bf16 diagonal blocks, x rounded to bf16 in both
    orientations, from init or zero."""
    rng = np.random.default_rng(7)
    nb = 4
    blocks = (rng.standard_normal((nb, 128, 128))
              * (rng.random((nb, 128, 128)) < 0.1)).astype(np.float32)
    x = rng.standard_normal((nb * 128, 16)).astype(np.float32)
    init = rng.standard_normal((nb * 128, 16)).astype(np.float32)
    got = diag_spmm(torch.from_numpy(blocks).to(BF16), torch.from_numpy(x),
                    2, transpose=transpose,
                    init=torch.from_numpy(init) if with_init else None)
    ref = diag_spmm_raw(jnp.asarray(blocks).astype(jnp.bfloat16),
                        jnp.asarray(x), 2, transpose=transpose,
                        init=jnp.asarray(init) if with_init else None)
    close(got, ref)
    a = round_bf16(blocks).astype(np.float64)
    a = a.transpose(0, 2, 1) if transpose else a
    prod = np.einsum("bij,bjf->bif", a, round_bf16(x).reshape(nb, 128, 16))
    close(ref, prod.reshape(-1, 16) + (init if with_init else 0.0))
    assert diag_spmm.launches == diag_spmm.launches_bf16 == 0


# the hybrid operator: build_hybrid's flags, and the tolerance of its
# chain (the diagonal's batched matmul and the einsum round to bf16)
HYBRID = {"default": (dict(tile_dtype="bf16"), F32_TOL),
          "diag": (dict(tile_dtype="bf16", use_diag=True), F32_TOL),
          "diag_rowwalk": (dict(tile_dtype="bf16", use_diag=True,
                                use_rowwalk=True), BF16_TOL),
          "einsum": (dict(tile_dtype="bf16", use_einsum_tiles=True),
                     BF16_TOL),
          "einsum_f32": (dict(use_einsum_tiles=True), F32_TOL)}


def _hybrid_pair(case, n=768, **extra):
    s, r, w = sorted_coo(np.random.default_rng(8), n, 9000)
    kw = dict(HYBRID[case][0], min_block_edges=20, use_segmm=True, **extra)
    bf = kw.pop("tile_dtype", None) == "bf16"
    return (build_hybrid(s, r, w, n, tile_dtype=BF16 if bf else None, **kw),
            jax_build_hybrid(s, r, w, n,
                             tile_dtype=jnp.bfloat16 if bf else None, **kw))


@pytest.mark.parametrize("case", list(HYBRID))
def test_build_hybrid_bf16_matches_jax(case):
    """The tiles and diagonal blocks in the JAX package's type and values,
    the layout flags, and no dynamic-tile plan on the einsum layout."""
    ht, hj = _hybrid_pair(case)
    for name in ("bsr", "diag_blocks"):
        t, j = getattr(ht, name), getattr(hj, name)
        assert (t is None) == (j is None), name
        if t is None:
            continue
        tb, jb = (t.blocks, j.blocks) if name == "bsr" else (t, j)
        assert str(jb.dtype) == str(tb.dtype).split(".")[-1]
        np.testing.assert_array_equal(as_f32(tb), as_f32(jb))
    assert (ht.bsr.rowwalk, ht.bsr.einsum) == (hj.bsr.rowwalk,
                                               hj.bsr.einsum)
    assert ht.diag_r == hj.diag_r
    ht_att, hj_att = _hybrid_pair(case if "diag" not in case else "default",
                                  semantics="att_unit")
    assert (ht_att.dyn_plan is None) == (hj_att.dyn_plan is None) == (
        ht_att.bsr.einsum)


@pytest.mark.parametrize("forward_only", [False, True])
@pytest.mark.parametrize("case", list(HYBRID))
def test_hybrid_spmm_bf16_matches_jax(case, forward_only):
    """``hybrid_spmm`` forward and gradient by each chain: K3 → K1 on bf16
    tiles, K3 → K8 → K1 under ``use_diag``, the diagonal's bf16 batched
    matmul beside K10, the einsum layout; and each forward without the
    BCSR's transpose (K2 or the einsum)."""
    ht, hj = _hybrid_pair(case)
    if forward_only:
        ht = dataclasses.replace(ht, bsr=dataclasses.replace(ht.bsr,
                                                             transpose=None))
        hj = hj.replace(bsr=hj.bsr.replace(transpose=None))
    tol = HYBRID[case][1]
    rng = np.random.default_rng(9)
    x = rng.standard_normal((768, 16)).astype(np.float32)
    tgt = rng.standard_normal((768, 16)).astype(np.float32)
    ref = jax_hybrid_spmm(hj, jnp.asarray(x))
    if forward_only:
        close(hybrid_spmm(ht, torch.from_numpy(x)), ref, tol)
        return
    dx_j = jax.grad(lambda xx: jnp.sum((jax_hybrid_spmm(hj, xx) - tgt) ** 2))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = hybrid_spmm(ht, xt)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    close(out, ref, tol)
    close(xt.grad, dx_j, tol)


@pytest.mark.parametrize("tile_dtype", ["f32", "bf16"])
def test_gat_attention_on_the_einsum_layout_matches_jax(tile_dtype):
    """GAT's tiles on the einsum layout, which has no dynamic-tile plan in
    either package: the JAX package's XLA branch (a batched einsum of
    ``pe`` and the gathered slabs, a sum over block rows), forward and the
    gradients of ``h``, ``att_src`` and ``score_dst``."""
    from fitgnn_tpu.ops.tile_gat import tile_gat_attention as jax_attention
    from fitgnn_tpu_torch.ops.tile_gat import tile_gat_attention

    rng = np.random.default_rng(13)
    n, feat = 768, 24
    s, r, _ = sorted_coo(rng, n, 9000)
    w = np.ones(len(s), np.float32)
    bf = tile_dtype == "bf16"
    kw = dict(min_block_edges=20, use_segmm=True, semantics="att_unit",
              use_einsum_tiles=True)
    ht = build_hybrid(s, r, w, n, tile_dtype=BF16 if bf else None, **kw)
    hj = jax_build_hybrid(s, r, w, n,
                          tile_dtype=jnp.bfloat16 if bf else None, **kw)
    assert ht.dyn_plan is None and hj.dyn_plan is None and ht.bsr.einsum
    h = rng.standard_normal((n, feat)).astype(np.float32)
    a = (rng.standard_normal(feat) / np.sqrt(feat)).astype(np.float32)
    sd = rng.standard_normal(n).astype(np.float32)
    tgt = rng.standard_normal((n, feat)).astype(np.float32)

    def loss_j(hh, aa, ss):
        out = jax_attention(hj, hh @ aa, ss, hh, 0.2, att_src=aa)
        return jnp.sum((out - tgt) ** 2), out

    (_, out_j), grads_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(h), jnp.asarray(a), jnp.asarray(sd))
    hh, at, st = (torch.tensor(v, requires_grad=True) for v in (h, a, sd))
    out = tile_gat_attention(ht, hh @ at, st, hh, 0.2, att_src=at)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    close(out, out_j)
    for got, ref in zip((hh.grad, at.grad, st.grad), grads_j):
        close_step(got, ref)


GAT_SWITCHES = {"GATConv": ({}, {}),
                "GATConv_fused": ({"_FUSED_TILES": True},
                                  {"FITGNN_GAT_FUSED_TILES": "1"})}


@pytest.mark.parametrize("layer", ["GCNConv", "SAGEConv", "GINConv",
                                   *GAT_SWITCHES])
def test_train_step_on_bf16_tiles_matches_jax(monkeypatch, layer):
    """One ``gc_train_step`` on the layer's bf16 operator from
    ``build_optimized_graph(tile_dtype=bfloat16)``, dropout off: the loss,
    every gradient and the parameters after Adam with L2.  GAT two-stage
    (K4 on the bf16 mask) and under ``FITGNN_GAT_FUSED_TILES=1`` (K7 on
    it)."""
    flags, env = GAT_SWITCHES.get(layer, ({}, {}))
    for k, v in flags.items():
        monkeypatch.setattr(jax_tile_gat_mod, k, v)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    name = layer.split("_")[0]
    rng = np.random.default_rng(6)
    x, s, r = community_graph(rng, 640, 16)
    y = rng.integers(0, 4, 640)
    mask = rng.random(640) < 0.5
    kw = dict(y=y, train_mask=mask, min_block_edges=80, layer_name=name)
    gt, _ = build_optimized_graph(x, s, r, tile_dtype=BF16, **kw)
    gj, _ = jax_build_optimized_graph(x, s, r, tile_dtype=jnp.bfloat16, **kw)
    assert gt.aux.bsr.blocks.dtype == BF16
    assert gj.aux.bsr.blocks.dtype == jnp.bfloat16
    assert (gt.aux.dyn_plan is not None) == (name == "GATConv")
    jm = JaxNodeModel(layer_name=name, hidden=32, num_layers=2, out_dim=4,
                      dropout_rate=0.0)
    state = jax_steps.create_state(jm, jax.random.PRNGKey(2), gj.x, gj)

    def loss_j(p):
        return jax_losses.masked_nll(jm.apply(p, gj.x, gj), gj.y,
                                     gj.train_mask)

    loss_ref, grads = jax.value_and_grad(loss_j)(state.params)
    new, _ = jax_steps.gc_train_step(state, gj, gj.y, gj.train_mask,
                                     jax.random.PRNGKey(0), "classification")
    model = NodeModel(name, 16, 32, 2, 4, dropout_rate=0.0)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, state.params)))
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    loss = steps.gc_train_step(model, opt, gt, gt.y, gt.train_mask, None,
                               "classification")
    close_step(loss, loss_ref)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    for k, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), k
        close_step(p.grad, ref[k])
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, new.params))
    for k, v in model.state_dict().items():
        close_step(v, ref[k])


@pytest.mark.parametrize("layer", ["GCNConv", "SAGEConv", "GINConv"])
def test_preaggregate_input_on_bf16_tiles_matches_jax(layer):
    """Layer 0's input at ingest, through K3 then K1 on the bf16 tiles (x
    rounded to bf16 there, as the JAX package rounds it)."""
    rng = np.random.default_rng(12)
    x, s, r = community_graph(rng, 640, 16)
    kw = dict(min_block_edges=80, layer_name=layer)
    gt, _ = build_optimized_graph(x, s, r, tile_dtype=BF16, **kw)
    gj, _ = jax_build_optimized_graph(x, s, r, tile_dtype=jnp.bfloat16, **kw)
    with torch.no_grad():
        got = preaggregate_input(gt, layer)
    ref = jax_preaggregate_input(gj, layer)
    close(got, ref)
    f32, _ = build_optimized_graph(x, s, r, **kw)
    with torch.no_grad():
        plain = preaggregate_input(f32, layer)
    assert not torch.equal(got, plain)            # the rounding took place


@pytest.fixture
def tile_types(monkeypatch):
    """The tile type of every hybrid operator built while the test runs."""
    built = []
    orig = hybrid_mod.build_hybrid

    def record(*args, **kwargs):
        h = orig(*args, **kwargs)
        built.append(None if h.bsr is None else h.bsr.blocks.dtype)
        return h

    monkeypatch.setattr(hybrid_mod, "build_hybrid", record)
    return built


def _cli(toy, layer):
    return ["--dataset", "toy", "--data_root", str(toy / "dataset"),
            "--hidden", "16", "--experiment", "random", "--device", "cpu",
            "--layer_name", layer, "--hybrid_spmm", "on",
            "--hybrid_threshold", "8"]


@pytest.mark.parametrize("layer", ["GCNConv", "SAGEConv", "GATConv"])
def test_cli_baseline_bf16_tiles(toy, tile_types, layer):
    """``train --baseline --hybrid_bf16_tiles`` builds a bf16 operator,
    trains to a finite row and a checkpoint that ``infer-baseline`` (which
    takes no such flag) serves on its f32 operator; the row is near the f32
    run's (the rounding of x moves it, not the model)."""
    common = _cli(toy, layer)
    for out, extra in (("f32", []), ("bf16", ["--hybrid_bf16_tiles"])):
        assert main(["train", "--baseline", "--runs", "1", "--epochs1",
                     "15", "--output_dir", out, *extra, *common]) == 0
    assert tile_types == [torch.float32, BF16]
    header, rows = _rows(toy / "results" / "baseline" / "toy.csv")
    assert len(rows) == 2 and all(r["layer_name"] == layer for r in rows)
    f32, bf = (float(r["best_loss"]) for r in rows)
    assert np.isfinite(bf) and abs(bf - f32) <= 2e-2 * abs(f32)
    assert float(rows[1]["best_acc"]) > 0.3
    assert main(["infer-baseline", "--num_test_samples", "32",
                 "--output_dir", "bf16", *common[:-4]]) == 0
    _, rows = _rows(toy / "inference_results" / "node_cls.csv")
    assert float(rows[0]["acc"]) > 0.3


@pytest.mark.parametrize("layer", ["GCNConv", "GATConv"])
def test_cli_curriculum_bf16_tiles(toy, tile_types, layer):
    """The curriculum ``train --hybrid_bf16_tiles``: Gc's operator is built
    with bf16 tiles, the Gc phase trains on it, the Gs phase and ``infer``
    run as without it."""
    common = _cli(toy, layer)
    assert main(["train", "--runs", "1", "--epochs1", "15", "--epochs2",
                 "10", "--exp_setup", "Gc_train_2_Gs_train",
                 "--hybrid_bf16_tiles", *common]) == 0
    assert tile_types == [BF16]
    _, rows = _rows(toy / "results" / "toy.csv")
    assert len(rows) == 1 and float(rows[0]["best_acc"]) > 0.3
    assert np.isfinite(float(rows[0]["best_loss"]))
    assert main(["infer", "--num_test_samples", "32", *common[:-4]]) == 0
    _, rows = _rows(toy / "inference_results" / "node_cls.csv")
    assert float(rows[0]["acc"]) > 0.3


@pytest.mark.parametrize("what", ["block"])
def test_unported_tile_options_raise(what):
    """``block != 128``, once refused, now builds the JAX package's bf16
    tiles at edge 256 (both directions); an edge off the multiples of 128
    raises ``ValueError``."""
    s, r, w = sorted_coo(np.random.default_rng(2), 512, 1000)
    bt = build_bsr(s, r, w, 512, block=256, tile_dtype=BF16)
    bj = jax_build_bsr(s, r, w, 512, block=256, tile_dtype=jnp.bfloat16)
    for mt, mj in ((bt, bj), (bt.transpose, bj.transpose)):
        assert mt.blocks.dtype == BF16 and mt.block == mj.block == 256
        np.testing.assert_array_equal(as_f32(mt.blocks), as_f32(mj.blocks))
        for name in ("rows", "cols", "row_splits"):
            np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                          np.asarray(getattr(mj, name)))
    with pytest.raises(ValueError, match="multiple of 128"):
        build_bsr(s, r, w, 512, block=192, tile_dtype=BF16)


@pytest.mark.parametrize("what", ["cluster_agg", "cluster_att"])
def test_cluster_collapse_on_bf16_tiles_matches_jax(what):
    """The collapses on bf16 tiles: the static table takes the tiles' type
    (bf16), the attention table bf16 by its count rule; every array equals
    the JAX package's, and so do the static operator's forward and
    gradient (within 8e-3·max|ref|: a summary rounded to bf16 can take the
    other neighbour under another order of its f32 sum) and the attention
    forward."""
    s, r, w = sorted_coo(np.random.default_rng(2), 512, 4000)
    att = what == "cluster_att"
    if att:
        w = np.ones_like(w)
    kw = dict(min_block_edges=60, use_segmm=True, real_nodes=500,
              semantics="att_unit" if att else "gcn_norm", **{what: 128})
    ht = build_hybrid(s, r, w, 512, tile_dtype=BF16, **kw)
    hj = jax_build_hybrid(s, r, w, 512, tile_dtype=jnp.bfloat16, **kw)
    assert ht.cluster_count.dtype == BF16 == ht.bsr.blocks.dtype
    assert hj.cluster_count.dtype == jnp.bfloat16
    for k in ("cluster_count", "cluster_scale", "cluster_member", "senders",
              "receivers", "weights", "t_edge_perm"):
        np.testing.assert_array_equal(as_f32(getattr(ht, k)),
                                      as_f32(getattr(hj, k)), err_msg=k)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((512, 16)).astype(np.float32)
    if att:
        a = (rng.standard_normal(16) / 4).astype(np.float32)
        sd = rng.standard_normal(512).astype(np.float32)
        ref = jax_tile_gat_mod.tile_gat_attention(
            hj, jnp.asarray(x @ a), jnp.asarray(sd), jnp.asarray(x), 0.2,
            att_src=jnp.asarray(a))
        xt = torch.from_numpy(x)
        got = tile_gat_attention(ht, xt @ torch.from_numpy(a),
                                 torch.from_numpy(sd), xt, 0.2,
                                 att_src=torch.from_numpy(a))
        close_step(got, ref)
        return
    g = rng.standard_normal((512, 16)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda xx: jax_hybrid_spmm(hj, xx), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = hybrid_spmm(ht, xt)
    out.backward(torch.from_numpy(g))
    close(out, out_j, 8e-3)
    close(xt.grad, vjp(jnp.asarray(g))[0], 8e-3)


def test_cli_cluster_aggregation_on_bf16_tiles(toy, tile_types, capsys):
    """``train --baseline --hybrid_bf16_tiles --cluster_aggregation 128``:
    a bf16 operator whose stragglers collapse onto a bf16 table, a finite
    row, and the JAX package's operator line."""
    common = _cli(toy, "GCNConv")
    assert main(["train", "--baseline", "--runs", "1", "--epochs1", "10",
                 "--hybrid_bf16_tiles", "--cluster_aggregation", "128",
                 *common, "--hybrid_threshold", "100"]) == 0
    assert tile_types == [BF16]
    out = capsys.readouterr().out
    assert "cluster-aggregation entries (K=128, approximate)" in out
    _, rows = _rows(toy / "results" / "baseline" / "toy.csv")
    assert len(rows) == 1 and np.isfinite(float(rows[0]["best_loss"]))
