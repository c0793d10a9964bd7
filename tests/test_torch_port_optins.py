"""The GCN step's kernel opt-ins against the JAX package, on the CPU.

The same numpy inputs go through both packages: the BCSR layouts of
``build_bsr(rowwalk=…, group=…)`` and their walks (K2, K9, K10), the
block-diagonal run (K8), the hybrid operator under ``use_diag`` /
``tile_group`` / ``use_rowwalk``, the in-kernel dropout (K11) and a GCN
train step.  The JAX Pallas kernels run in interpret mode; the port's
wrappers take their plain versions because the tensors lie on the CPU.
Tolerance: forward rtol 1e-4 and atol 1e-4·max|ref|, gradients rtol 1e-3
and atol 1e-3·max|ref| (f32 sums in another order); index arrays, K11's
bits and masks exactly.

K11 has no bit parity with the JAX package by design: its CPU path is a
``jax.random.uniform`` fallback and the TPU draws from another stream.  So
K11 is held to Random123's Philox4x32-10 vectors and to its own keep rule,
and the train step injects the port's masks into the JAX model.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fitgnn_tpu.ops.pallas.dropout as jax_dropout_mod
from fitgnn_tpu.graph.build import build_graph as jax_build_graph
from fitgnn_tpu.graph.optimize import \
    build_optimized_graph as jax_build_optimized_graph
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.hybrid_spmm import hybrid_spmm as jax_hybrid_spmm
from fitgnn_tpu.ops.pallas.bsr_spmm import build_bsr as jax_build_bsr
from fitgnn_tpu.ops.pallas.bsr_spmm import bsr_spmm as jax_bsr_spmm
from fitgnn_tpu.ops.pallas.bsr_spmm import bsr_spmm_acc_raw
from fitgnn_tpu.ops.pallas.diag_spmm import diag_spmm_raw
from fitgnn_tpu.ops.pallas.diag_spmm import \
    pick_run_length as jax_pick_run_length
from fitgnn_tpu.train import losses as jax_losses

from fitgnn_tpu_torch.graph.build import build_graph
from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
from fitgnn_tpu_torch.models import models as models_mod
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.ops.bsr_spmm import (build_bsr, bsr_spmm, bsr_spmm_acc,
                                           bsr_spmm_fwd, bsr_spmm_grouped,
                                           bsr_spmm_rowwalk)
from fitgnn_tpu_torch.ops.coo_segmm import build_segmm, segmm_spmm
from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm, pick_run_length
from fitgnn_tpu_torch.ops.dropout import (dropout_bits, fused_dropout,
                                          philox4x32, philox_dropout,
                                          seed_from_generator)
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid, hybrid_spmm
from fitgnn_tpu_torch.ops.spmm import spmm
from fitgnn_tpu_torch.train import steps

torch.set_num_threads(1)


def close(got, ref, grad=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    tol = 1e-3 if grad else 1e-4
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max(initial=0.0)))


def sorted_coo(rng, n, e, block=128, internal=0.8, skip_block=None):
    """Receiver-sorted COO with most edges inside the diagonal blocks; no
    edge lands in block row (and column) ``skip_block``."""
    r = np.sort(rng.integers(0, n, e)).astype(np.int64)
    s_in = (r // block) * block + rng.integers(0, block, e)
    s = np.where(rng.random(e) < internal, s_in,
                 rng.integers(0, n, e)).astype(np.int64)
    w = rng.random(e).astype(np.float32)
    if skip_block is not None:
        keep = (r // block != skip_block) & (s // block != skip_block)
        s, r, w = s[keep], r[keep], w[keep]
    return s, r, w


LAYOUTS = {"gridwalk": {}, "group2": dict(group=2), "group4": dict(group=4),
           "rowwalk": dict(rowwalk=True)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_build_bsr_layouts_match_jax(layout):
    """A fixed tile pattern on 6 block rows: row 2 has no tile (a coverage
    filler in the grid-walk and grouped layouts, padded too; none in the
    row walk), the rows hold 1 to 3 tiles (so groups of 2 and 4 pad them)
    and their first tiles, whose column the pads reuse, lie in different
    block columns."""
    rng = np.random.default_rng(1)
    pairs = [(0, 0), (0, 1), (1, 1), (1, 3), (1, 4), (3, 3), (3, 5), (4, 0),
             (4, 4), (5, 5)]
    r = np.concatenate([br * 128 + rng.integers(0, 128, 30)
                        for br, _ in pairs])
    s = np.concatenate([bc * 128 + rng.integers(0, 128, 30)
                        for _, bc in pairs])
    order = np.argsort(r, kind="stable")
    s, r = s[order], r[order]
    w = rng.random(len(r)).astype(np.float32)
    kw = LAYOUTS[layout]
    bt, bj = build_bsr(s, r, w, 768, **kw), jax_build_bsr(s, r, w, 768, **kw)
    for mt, mj in ((bt, bj), (bt.transpose, bj.transpose)):
        for name in ("blocks", "rows", "cols", "row_splits"):
            np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                          np.asarray(getattr(mj, name)),
                                          err_msg=name)
        assert (mt.rowwalk, mt.group) == (mj.rowwalk, mj.group)
    splits = bt.row_splits.numpy()
    if layout != "rowwalk":
        assert bt.cols.numpy()[splits[:-1]].tolist() == [0, 1, 0, 3, 0, 5]
    assert (splits[3] == splits[2]) == (layout == "rowwalk")
    if bt.group > 1:
        assert (np.diff(splits) % bt.group == 0).all()


@pytest.mark.parametrize("kw", [dict(block=256), dict(einsum=True),
                                dict(tile_dtype="bfloat16")])
def test_build_bsr_unported_variants_raise(kw):
    s, r, w = sorted_coo(np.random.default_rng(2), 512, 1000)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 2"):
        build_bsr(s, r, w, 512, **kw)


WALKS = {"gridwalk": bsr_spmm_fwd, "group2": bsr_spmm_grouped,
         "group4": bsr_spmm_grouped, "rowwalk": bsr_spmm_rowwalk}


@pytest.mark.parametrize("feat", [16, 128])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_bsr_spmm_matches_jax(layout, feat):
    """``spmm(operator=BsrMatrix)`` forward and gradient (K2, K9, K10 by
    the layout) against the JAX ``bsr_spmm``; block row 2 is empty."""
    rng = np.random.default_rng(3)
    n = 768
    s, r, w = sorted_coo(rng, n, 5000, skip_block=2)
    kw = LAYOUTS[layout]
    bt, bj = build_bsr(s, r, w, n, **kw), jax_build_bsr(s, r, w, n, **kw)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    tgt = rng.standard_normal((n, feat)).astype(np.float32)
    out_j, dx_j = jax.value_and_grad(
        lambda xx: jnp.sum((jax_bsr_spmm(bj, xx) - tgt) ** 2))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out_t = spmm(None, None, None, xt, n, operator=bt)
    close(out_t, jax_bsr_spmm(bj, jnp.asarray(x)))
    assert not out_t[2 * 128:3 * 128].any()
    ((out_t - torch.from_numpy(tgt)) ** 2).sum().backward()
    close(xt.grad, dx_j, grad=True)
    # the layout picks the walk; the CPU takes its plain version
    close(WALKS[layout](bt, torch.from_numpy(x)), out_t.detach())
    assert WALKS[layout].launches == 0


@pytest.mark.parametrize("layout", ["group2", "rowwalk"])
def test_bsr_spmm_acc_on_walk_layouts_matches_jax(layout):
    """``init + A·x`` on the grouped and row-walk layouts, as
    ``bsr_spmm_acc_raw`` adds ``init`` to K9's or K10's output."""
    rng = np.random.default_rng(4)
    n = 512
    s, r, w = sorted_coo(rng, n, 3000)
    kw = LAYOUTS[layout]
    bt, bj = build_bsr(s, r, w, n, **kw), jax_build_bsr(s, r, w, n, **kw)
    x, init = (rng.standard_normal((n, 16)).astype(np.float32)
               for _ in range(2))
    close(bsr_spmm_acc(bt, torch.from_numpy(x), torch.from_numpy(init)),
          bsr_spmm_acc_raw(bj, jnp.asarray(x), jnp.asarray(init)))
    assert bsr_spmm_acc.launches == 0


def test_bsr_walks_refuse_other_layouts():
    s, r, w = sorted_coo(np.random.default_rng(5), 256, 500)
    x = torch.zeros(256, 4)
    with pytest.raises(ValueError):
        bsr_spmm_fwd(build_bsr(s, r, w, 256, group=2), x)
    with pytest.raises(ValueError):
        bsr_spmm_grouped(build_bsr(s, r, w, 256), x)
    with pytest.raises(ValueError):
        bsr_spmm_rowwalk(build_bsr(s, r, w, 256), x)
    with pytest.raises(ValueError, match="with_transpose"):
        bsr_spmm(build_bsr(s, r, w, 256, with_transpose=False),
                 x.requires_grad_())


class EllMatrix:
    """A stand-in with the JAX package's ELL operator's name."""


def test_spmm_dispatch():
    rng = np.random.default_rng(6)
    n = 512
    s, r, w = sorted_coo(rng, n, 2000)
    x = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    ref = np.zeros((n, n), np.float32)
    np.add.at(ref, (r, s), w)
    ref = ref @ x.numpy()
    h = build_hybrid(s, r, w, n, min_block_edges=20, use_segmm=True)
    for op in (None, h, build_bsr(s, r, w, n), build_segmm(s, r, w, n)):
        close(spmm(torch.from_numpy(w), torch.from_numpy(s),
                   torch.from_numpy(r), x, n, operator=op), ref)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        spmm(None, None, None, x, n, operator=EllMatrix())
    assert segmm_spmm.launches == 0


@pytest.mark.parametrize("feat", [16, 128])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
def test_diag_spmm_matches_jax(transpose, with_init, feat):
    rng = np.random.default_rng(7)
    nb = 4
    blocks = (rng.standard_normal((nb, 128, 128))
              * (rng.random((nb, 128, 128)) < 0.1)).astype(np.float32)
    x = rng.standard_normal((nb * 128, feat)).astype(np.float32)
    init = rng.standard_normal((nb * 128, feat)).astype(np.float32)
    out = diag_spmm(torch.from_numpy(blocks), torch.from_numpy(x), 2,
                    transpose=transpose,
                    init=torch.from_numpy(init) if with_init else None)
    ref = diag_spmm_raw(jnp.asarray(blocks), jnp.asarray(x), 2,
                        transpose=transpose,
                        init=jnp.asarray(init) if with_init else None)
    close(out, ref)
    assert diag_spmm.launches == 0


def test_diag_spmm_checks_run_length():
    assert [pick_run_length(nb) for nb in (1, 6, 9, 1324, 1327)] == [
        jax_pick_run_length(nb) for nb in (1, 6, 9, 1324, 1327)]
    assert pick_run_length(1324) == 4
    with pytest.raises(ValueError, match="multiple of r=3"):
        diag_spmm(torch.zeros(4, 128, 128), torch.zeros(512, 8), 3)


HYBRID = {"diag": dict(use_diag=True),
          "diag_r2": dict(use_diag=True, diag_r=2),
          "diag_bmm": dict(use_diag=True, diag_r=0),
          "group2": dict(tile_group=2),
          "rowwalk": dict(use_rowwalk=True),
          "diag_group2": dict(use_diag=True, tile_group=2)}


def _hybrid_pair(kw, n=768, e=9000, min_block_edges=40, seed=8):
    s, r, w = sorted_coo(np.random.default_rng(seed), n, e, skip_block=2)
    args = dict(min_block_edges=min_block_edges, use_segmm=True, **kw)
    return (build_hybrid(s, r, w, n, **args),
            jax_build_hybrid(s, r, w, n, **args))


@pytest.mark.parametrize("case", list(HYBRID))
def test_build_hybrid_opt_ins_match_jax(case):
    ht, hj = _hybrid_pair(HYBRID[case])
    assert ht.diag_r == hj.diag_r
    assert (ht.diag_blocks is None) == (hj.diag_blocks is None)
    if ht.diag_blocks is not None:
        np.testing.assert_array_equal(ht.diag_blocks.numpy(),
                                      np.asarray(hj.diag_blocks))
    for name in ("senders", "receivers", "weights", "t_senders",
                 "t_receivers", "t_weights", "t_edge_perm"):
        np.testing.assert_array_equal(getattr(ht, name).numpy(),
                                      np.asarray(getattr(hj, name)),
                                      err_msg=name)
    assert ht.bsr is not None and hj.bsr is not None
    for mt, mj in ((ht.bsr, hj.bsr), (ht.bsr.transpose, hj.bsr.transpose)):
        for name in ("blocks", "rows", "cols", "row_splits"):
            np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                          np.asarray(getattr(mj, name)),
                                          err_msg=name)
        assert (mt.rowwalk, mt.group) == (mj.rowwalk, mj.group)
    if "diag" in case:
        # the BCSR keeps only the off-diagonal dense tiles
        real = (ht.bsr.blocks != 0).flatten(1).any(1)
        assert (ht.bsr.rows[real] != ht.bsr.cols[real]).all()


@pytest.mark.parametrize("feat", [16, 128])
@pytest.mark.parametrize("case", list(HYBRID) + ["diag_no_offdiag"])
def test_hybrid_opt_ins_match_jax(case, feat):
    """Forward and gradient; ``diag_no_offdiag`` has dense tiles only on
    the diagonal, so the BCSR is ``None`` and the chain is K3 → K8."""
    if case == "diag_no_offdiag":
        ht, hj = _hybrid_pair(dict(use_diag=True), min_block_edges=200)
        assert ht.bsr is None and hj.bsr is None
        assert ht.diag_blocks is not None and ht.diag_r == hj.diag_r == 6
    else:
        ht, hj = _hybrid_pair(HYBRID[case])
    rng = np.random.default_rng(9)
    x = rng.standard_normal((768, feat)).astype(np.float32)
    tgt = rng.standard_normal((768, feat)).astype(np.float32)
    _, dx_j = jax.value_and_grad(
        lambda xx: jnp.sum((jax_hybrid_spmm(hj, xx) - tgt) ** 2))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = hybrid_spmm(ht, xt)
    close(out, jax_hybrid_spmm(hj, jnp.asarray(x)))
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    close(xt.grad, dx_j, grad=True)


def test_hybrid_without_transpose_runs_bsr_spmm():
    """A forward-only operator (the BCSR without its transpose) takes the
    straggler part plus ``bsr_spmm`` (K2), as the JAX package's."""
    ht, hj = _hybrid_pair({})
    ht = dataclasses.replace(ht, bsr=dataclasses.replace(ht.bsr,
                                                         transpose=None))
    hj = hj.replace(bsr=hj.bsr.replace(transpose=None))
    x = np.random.default_rng(10).standard_normal((768, 16)).astype(
        np.float32)
    with torch.inference_mode():
        out = hybrid_spmm(ht, torch.from_numpy(x))
    close(out, jax_hybrid_spmm(hj, jnp.asarray(x)))


@pytest.mark.parametrize("kw", [dict(use_diag=True), dict(use_rowwalk=True),
                                dict(tile_group=2)])
def test_att_unit_refuses_tile_opt_ins(kw):
    s, r, w = sorted_coo(np.random.default_rng(11), 512, 3000)
    with pytest.raises(NotImplementedError, match="att_unit"):
        build_hybrid(s, r, w, 512, min_block_edges=20, semantics="att_unit",
                     **kw)
    if "use_rowwalk" not in kw:     # build_optimized_graph has no rowwalk
        x = np.zeros((512, 4), np.float32)
        with pytest.raises(NotImplementedError, match="att_unit"):
            build_optimized_graph(x, s, r, layer_name="GATConv", **kw)


# --- K11 ------------------------------------------------------------------

def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    def words(ctr, key):
        t = [torch.tensor(v, dtype=torch.int64) for v in (*ctr, *key)]
        return [int(v) for v in philox4x32(tuple(t[:4]), tuple(t[4:]))]
    ones = 0xFFFFFFFF
    assert words((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert words((ones,) * 4, (ones, ones)) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert words((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
                 (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]
    # element i takes word i % 4 of the block at counter i // 4
    bits = dropout_bits(torch.zeros(1, dtype=torch.int32), 6)
    assert bits[:4].tolist() == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                 0x9B00DBD8]
    assert bits[4:].tolist() == words((1, 0, 0, 0), (0, 0))[:2]


@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_fused_dropout_keep_rule(rate):
    """Keep rate within 4σ of 1 − rate; values exactly 0 or x·scale, with
    scale the f32 of 1/(1−rate), multiplied; one seed, one mask."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((256, 509)).astype(np.float32))
    seed = torch.tensor([1234], dtype=torch.int32)
    out = philox_dropout(x, seed, rate)
    kept = out != 0
    n = x.numel()
    assert abs(float(kept.float().mean()) - (1 - rate)) \
        < 4 * np.sqrt(rate * (1 - rate) / n)
    scale = torch.tensor(np.float32(1.0 / (1.0 - rate)))
    assert torch.equal(out[kept], x[kept] * scale)
    thresh = int(rate * 2 ** 32)
    assert torch.equal(kept, dropout_bits(seed, n).reshape(x.shape)
                       >= thresh)
    assert torch.equal(philox_dropout(x, seed.clone(), rate), out)
    assert not torch.equal(
        philox_dropout(x, torch.tensor([1235], dtype=torch.int32), rate),
        out)
    assert philox_dropout.launches == 0


def test_fused_dropout_backward_regenerates_the_mask():
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.standard_normal((64, 33)).astype(np.float32),
                     requires_grad=True)
    g = torch.from_numpy(rng.standard_normal((64, 33)).astype(np.float32))
    seed = seed_from_generator(torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    assert seed.dtype == torch.int32 and seed.shape == (1,)
    out = fused_dropout(x, seed, 0.3)
    out.backward(g)
    assert torch.equal(x.grad, philox_dropout(g, seed, 0.3))
    assert torch.equal(x.grad != 0, out != 0)


def test_fused_dropout_rejects_bad_rate_and_seed():
    x = torch.ones(4, 4)
    with pytest.raises(ValueError, match="rate"):
        philox_dropout(x, torch.zeros(1, dtype=torch.int32), 1.0)
    with pytest.raises(ValueError, match="seed"):
        philox_dropout(x, torch.zeros(2, dtype=torch.int32), 0.5)


PRECEDENCE = [  # (bit_dropout, fused_dropout, rate, K11 calls a forward)
    (True, True, 0.5, 0), (False, True, 0.5, 2), (True, True, 0.3, 2),
    (False, False, 0.5, 0), (True, False, 0.3, 0), (False, True, 0.0, 0)]


@pytest.mark.parametrize("bit,fused,rate,calls", PRECEDENCE)
def test_conv_stack_dropout_precedence_matches_jax(monkeypatch, bit, fused,
                                                   rate, calls):
    """Bit dropout at rate ½ shadows the fused one, as in the JAX
    ``ConvStack``; both packages call their fused dropout as often."""
    rng = np.random.default_rng(14)
    n, f = 64, 8
    s = rng.integers(0, n, 300)
    r = rng.integers(0, n, 300)
    x = rng.standard_normal((n, f)).astype(np.float32)
    calls_j, calls_t = [], []

    def spy_j(xx, seed, rr):
        calls_j.append(rr)
        return xx

    real = models_mod.fused_dropout

    def spy_t(xx, seed, rr):
        calls_t.append(rr)
        return real(xx, seed, rr)

    monkeypatch.setattr(jax_dropout_mod, "fused_dropout", spy_j)
    monkeypatch.setattr(models_mod, "fused_dropout", spy_t)
    gj = jax_build_graph(x, s, r)
    jm = JaxNodeModel(layer_name="GCNConv", hidden=16, num_layers=2,
                      out_dim=3, dropout_rate=rate, fused_dropout=fused,
                      bit_dropout=bit)
    params = jm.init(jax.random.PRNGKey(0), gj.x, gj)
    jm.apply(params, gj.x, gj, train=True,
             rngs={"dropout": jax.random.PRNGKey(1)})
    model = NodeModel("GCNConv", f, 16, 2, 3, dropout_rate=rate,
                      fused_dropout=fused, bit_dropout=bit)
    model.reset_parameters(torch.Generator().manual_seed(0)).train()
    gt = build_graph(x, s, r)
    model(gt.x, gt, torch.Generator().manual_seed(0))
    assert len(calls_j) == len(calls_t) == calls


def _layer_masks(gen_seed, n, hidden, rate, layers=2):
    """The masks the port's layers draw: one seed a layer from the
    generator, then K11's bits."""
    gen = torch.Generator().manual_seed(gen_seed)
    thresh = int(rate * 2 ** 32)
    return [np.asarray(dropout_bits(seed_from_generator(
        gen, torch.device("cpu")), n * hidden).reshape(n, hidden) >= thresh)
        for _ in range(layers)]


def _opt_in_graphs(case):
    """A block-structured graph (no reorder) with a GCN operator built by
    each package's ``build_hybrid`` under the opt-in, as ``bench.py``
    attaches it."""
    rng = np.random.default_rng(15)
    n, f, e = 640, 16, 6400
    r = rng.integers(0, n, e)
    # 70% inside the block, 15% into the next block (dense off-diagonal
    # tiles), 15% anywhere (stragglers)
    u = rng.random(e)
    blk = np.where(u < 0.7, r // 128, (r // 128 + 1) % 5)
    s = np.where(u < 0.85, blk * 128 + rng.integers(0, 128, e),
                 rng.integers(0, n, e))
    keep = s != r
    s, r = s[keep], r[keep]
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, 4, n)
    mask = rng.random(n) < 0.5
    gt = build_graph(x, s, r, y=y, train_mask=mask, node_pad_to=128)
    gj = jax_build_graph(x, s, r, y=y, train_mask=mask, node_pad_to=128)
    args = (gt.senders.numpy().astype(np.int64),
            gt.receivers.numpy().astype(np.int64), gt.edge_weight.numpy(),
            gt.num_nodes_padded)
    kw = dict(min_block_edges=100, use_segmm=True, **HYBRID[case])
    ht, hj = build_hybrid(*args, **kw), jax_build_hybrid(*args, **kw)
    assert ht.bsr is not None and ht.num_coo_edges > 1
    return gt._replace(aux=ht), gj._replace(aux=hj)


@pytest.mark.parametrize("case", ["diag", "group2", "rowwalk"])
def test_gcn_train_step_with_fused_dropout_matches_jax(monkeypatch, case):
    """One ``gc_train_step`` of GCN (hidden 32, dropout ½ through K11, bit
    dropout off) on each opt-in operator: the loss and every gradient
    against the JAX step with the port's masks injected in place of its
    fused dropout."""
    gt, gj = _opt_in_graphs(case)
    n, hidden, rate = gt.num_nodes_padded, 32, 0.5
    masks = _layer_masks(7, n, hidden, rate)
    scale = np.float32(1.0 / (1.0 - rate))
    calls = []

    def injected(xx, seed, rr):
        m = jnp.asarray(masks[len(calls) % len(masks)])
        calls.append(rr)
        return jnp.where(m, xx * scale, 0.0)

    monkeypatch.setattr(jax_dropout_mod, "fused_dropout", injected)
    jm = JaxNodeModel(layer_name="GCNConv", hidden=hidden, num_layers=2,
                      out_dim=4, dropout_rate=rate, fused_dropout=True,
                      bit_dropout=False)
    tiny = jax_build_graph(np.asarray(gj.x)[:8], np.arange(4), np.arange(4))
    params = jm.init(jax.random.PRNGKey(2), tiny.x, tiny)

    def loss_j(p):
        out = jm.apply(p, gj.x, gj, train=True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_losses.masked_nll(out, gj.y, gj.train_mask)

    loss_ref, grads = jax.value_and_grad(loss_j)(params)
    assert len(calls) == 2
    model = NodeModel("GCNConv", 16, hidden, 2, 4, dropout_rate=rate,
                      fused_dropout=True, bit_dropout=False)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, params)))
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    loss = steps.gc_train_step(model, opt, gt, gt.y, gt.train_mask,
                               torch.Generator().manual_seed(7),
                               "classification")
    close(loss, loss_ref)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        close(p.grad, ref[name], grad=True)


def test_optimized_graph_passes_opt_ins_through():
    rng = np.random.default_rng(16)
    n = 700
    r = rng.integers(0, n, n * 12)
    s = np.where(rng.random(n * 12) < 0.9,
                 np.minimum((r // 128) * 128 + rng.integers(0, 128, n * 12),
                            n - 1), rng.integers(0, n, n * 12))
    keep = s != r
    x = rng.standard_normal((n, 4)).astype(np.float32)
    kw = dict(min_block_edges=20, use_diag=True, tile_group=2)
    gt, order_t = build_optimized_graph(x, s[keep], r[keep], **kw)
    gj, order_j = jax_build_optimized_graph(x, s[keep], r[keep], **kw)
    np.testing.assert_array_equal(order_t, order_j)
    assert gt.aux.diag_r == gj.aux.diag_r > 0
    np.testing.assert_array_equal(gt.aux.diag_blocks.numpy(),
                                  np.asarray(gj.aux.diag_blocks))
    assert gt.aux.bsr.group == 2
    np.testing.assert_array_equal(gt.aux.bsr.cols.numpy(),
                                  np.asarray(gj.aux.bsr.cols))
