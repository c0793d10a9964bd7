"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels build at
first use) and skips without one; ``chip_smoke.py`` runs the same checks on
the card at the bench graph's shapes.  Tolerance: rtol 1e-4 and atol
1e-4·max|ref|, f32 sums taken in another order; training gradients on the
card are held against the plain versions on the CPU the same way.
"""

import numpy as np
import pytest
import torch

from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.ops import att_bsr
from fitgnn_tpu_torch.ops.bsr_dynamic import (build_dyn_plan, dyn_grad_blocks,
                                              dyn_grad_blocks_plain,
                                              dyn_tiles, dyn_tiles_plain,
                                              dyn_tiles_t, dyn_tiles_t_plain)
from fitgnn_tpu_torch.ops import dropout as dropout_mod
from fitgnn_tpu_torch.ops.bsr_spmm import (build_bsr, bsr_spmm_acc,
                                           bsr_spmm_acc_plain, bsr_spmm_fwd,
                                           bsr_spmm_grouped, bsr_spmm_plain,
                                           bsr_spmm_raw, bsr_spmm_rowwalk)
from fitgnn_tpu_torch.ops.coo_segmm import (build_segmm, segmm_spmm,
                                            segmm_spmm_plain,
                                            segmm_weighted_den_raw,
                                            segmm_weighted_den_raw_plain,
                                            segmm_weighted_raw)
from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm, diag_spmm_plain
from fitgnn_tpu_torch.ops.dropout import philox_dropout, \
    philox_dropout_plain
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid, hybrid_spmm
from fitgnn_tpu_torch.train.losses import masked_nll

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, ref):
    atol = 1e-4 * float(ref.abs().max())
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=atol)


def _coo(rng, n, e, internal=0.8):
    r = np.sort(rng.integers(0, n, e))
    s = np.where(rng.random(e) < internal,
                 (r // 128) * 128 + rng.integers(0, 128, e),
                 rng.integers(0, n, e))
    return s, r, rng.random(e).astype(np.float32)


@pytest.mark.parametrize("feat", [16, 100, 128, 512])
def test_k1_kernel_matches_plain(cuda, feat):
    rng = np.random.default_rng(feat)
    n = 1024
    s, r, w = _coo(rng, n, 20_000)
    b = build_bsr(s, r, w, n).to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, feat)).astype(np.float32))
    init = torch.from_numpy(rng.standard_normal((n, feat)).astype(
        np.float32))
    before = bsr_spmm_acc.launches
    with torch.inference_mode():
        got = bsr_spmm_acc(b, x.to(cuda), init.to(cuda))
        ref = bsr_spmm_acc_plain(b, x.to(cuda), init.to(cuda))
    torch.cuda.synchronize()
    assert bsr_spmm_acc.launches == before + 1
    _close(got, ref)


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary (a view one float into a larger buffer)."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    start = next(i for i in range(4)
                 if (buf.data_ptr() + 4 * i) % 16 == 4)
    view = buf[start:start + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def _straggler_csr(rng, n=1024):
    """A receiver-sorted straggler list with spread edges, a hub row of
    5,000 edges (row 5), a run of 64 rows with 200 edges each (rows
    600-663: more edges than one staging window of any CTA that holds
    them), empty rows, an empty block (rows 384-511) and inert edges of
    static weight 0."""
    s, r, w = _coo(rng, n, 3_000, internal=0.0)
    r = np.concatenate([r, np.full(5_000, 5), np.repeat(np.arange(600, 664),
                                                        200)])
    s = np.concatenate([s, rng.integers(0, n, len(r) - len(s))])
    w = np.concatenate([w, rng.random(len(r) - len(w)).astype(np.float32)])
    w[::17] = 0.0
    order = np.argsort(r, kind="stable")
    s, r, w = s[order], r[order], w[order]
    keep = (r // 128) != 3
    return s[keep], r[keep], w[keep]


# every lane count of the kernel (8, 16, 32 lanes a row; 128-column chunks
# at F=512); F=101 (F % 4 != 0) and the unaligned views take its scalar
# branch, the others its 16-byte vector branch
SEGMM_SHAPES = [(8, True), (16, True), (40, True), (64, True), (100, True),
                (101, True), (128, True), (512, True), (40, False),
                (128, False)]


def _segmm_inputs(cuda, feat, aligned, seed):
    rng = np.random.default_rng(feat + seed)
    s, r, w = _straggler_csr(rng)
    m = build_segmm(s, r, w, 1024).to(cuda)
    x = torch.from_numpy(rng.standard_normal((1024, feat)).astype(
        np.float32)).to(cuda)
    w_edge = torch.from_numpy(rng.random(len(s)).astype(np.float32)).to(cuda)
    return rng, m, (x if aligned else _unaligned(x)), w_edge


@pytest.mark.parametrize("feat,aligned", SEGMM_SHAPES)
def test_k3_kernel_matches_plain(cuda, feat, aligned):
    _, m, xd, _ = _segmm_inputs(cuda, feat, aligned, 1)
    before = segmm_spmm.launches
    with torch.inference_mode():
        got = segmm_spmm(m, xd)
        again = segmm_spmm(m, xd)
        ref = segmm_spmm_plain(m, xd)
    torch.cuda.synchronize()
    assert segmm_spmm.launches == before + 2
    _close(got, ref)
    assert torch.equal(got, again)                 # two launches bit-equal
    assert not got[3 * 128:4 * 128].any()          # the empty block


def test_hybrid_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    n = 1024
    s, r, w = _coo(rng, n, 15_000)
    h = build_hybrid(s, r, w, n, min_block_edges=48, use_segmm=True)
    assert h.bsr is not None
    x = torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32))
    with torch.inference_mode():
        got = hybrid_spmm(h.to(cuda), x.to(cuda)).cpu()
    _close(got, hybrid_spmm(h, x))


def _tiles(rng, nb=6, k=15):
    """A sorted tile list covering every block row; block column 2 is never
    used, so the transpose plan carries a filler there."""
    rows = np.sort(np.concatenate([np.arange(nb),
                                   rng.integers(0, nb, k - nb)]))
    cols = rng.choice([c for c in range(nb) if c != 2], len(rows))
    return rows.astype(np.int32), cols.astype(np.int32), nb


@pytest.mark.parametrize("feat", [16, 100, 128, 512])
def test_k4_k5_kernels_match_plain(cuda, feat):
    rng = np.random.default_rng(feat + 2)
    rows, cols, nb = _tiles(rng)
    plan = build_dyn_plan(rows, cols, nb).to(cuda)
    rt, ct = torch.from_numpy(rows).to(cuda), torch.from_numpy(cols).to(cuda)
    blocks = torch.from_numpy(rng.standard_normal(
        (len(rows), 128, 128)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((nb * 128, feat)).astype(
        np.float32)).to(cuda)
    g = torch.from_numpy(rng.standard_normal((nb * 128, feat)).astype(
        np.float32)).to(cuda)
    before = (dyn_tiles.launches, dyn_tiles_t.launches,
              dyn_grad_blocks.launches)
    with torch.inference_mode():
        got = (dyn_tiles(rt, ct, plan, blocks, x),
               dyn_tiles_t(plan, blocks, g), dyn_grad_blocks(rt, ct, g, x))
        ref = (dyn_tiles_plain(rt, ct, plan, blocks, x),
               dyn_tiles_t_plain(plan, blocks, g),
               dyn_grad_blocks_plain(rt, ct, g, x))
    torch.cuda.synchronize()
    assert (dyn_tiles.launches, dyn_tiles_t.launches,
            dyn_grad_blocks.launches) == tuple(b + 1 for b in before)
    for a, b in zip(got, ref):
        _close(a, b)
    assert not got[1][2 * 128:3 * 128].any()     # the filler's block


# F=101 and the unaligned g take K5's 4-byte loads; F=0 writes zeros
@pytest.mark.parametrize("feat,aligned", [(0, True), (16, True), (40, True),
                                          (101, True), (512, True),
                                          (64, False)])
def test_k5_tensor_cores_keep_f32_accuracy(cuda, feat, aligned):
    """K5 on the tensor cores (TF32 operands split into hi and lo): the
    dense product of every tile, a coverage filler (block row 4, column 0,
    whose forward values are zero) included, within the tolerance of its
    plain f32 version, and within 1e-5·max|ref| of each tile's float64
    product, where one TF32 pass misses by ~2e-4; the g slab of block row 1
    is scaled by 1e3, so tiles of both magnitudes are held."""
    rng = np.random.default_rng(feat + 20)
    rows, cols, nb = _tiles(rng)
    first = int(np.searchsorted(rows, 4))
    rows, cols = np.insert(rows, first, 4), np.insert(cols, first, 0)
    g = rng.standard_normal((nb * 128, feat)).astype(np.float32)
    g[128:256] *= 1e3
    x = rng.standard_normal((nb * 128, feat)).astype(np.float32)
    rt, ct = torch.from_numpy(rows).to(cuda), torch.from_numpy(cols).to(cuda)
    gd, xd = torch.from_numpy(g).to(cuda), torch.from_numpy(x).to(cuda)
    gd = gd if aligned else _unaligned(gd)
    before = dyn_grad_blocks.launches
    with torch.inference_mode():
        got = dyn_grad_blocks(rt, ct, gd, xd)
        ref = dyn_grad_blocks_plain(rt, ct, gd, xd)
    torch.cuda.synchronize()
    assert dyn_grad_blocks.launches == before + 1
    assert got.shape == (len(rows), 128, 128)
    if feat == 0:
        assert not got.any()
        return
    _close(got, ref)
    ref64 = dyn_grad_blocks_plain(rt, ct, gd.double(), xd.double())
    err = (got.double() - ref64).abs().flatten(1).max(1).values
    assert (err <= 1e-5 * ref64.abs().flatten(1).max(1).values).all()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("feat,aligned", SEGMM_SHAPES)
def test_k3w_kernel_matches_plain(cuda, feat, aligned, transpose):
    """K3w forms ``w_edge[e]·weights[e]`` itself; on the transpose CSR (K3w
    and K6's ``dx``) ``w_edge[perm[e]]·weights[e]``, ``perm`` a
    permutation of the edges."""
    rng, m, xd, w_edge = _segmm_inputs(cuda, feat, aligned, 3)
    perm = (torch.from_numpy(rng.permutation(len(w_edge)).astype(np.int32))
            .to(cuda) if transpose else None)
    w_ref = w_edge if perm is None else w_edge[perm.long()]
    before = segmm_weighted_raw.launches
    with torch.inference_mode():
        got = segmm_weighted_raw(m, w_edge, xd, perm)
        again = segmm_weighted_raw(m, w_edge, xd, perm)
        ref = segmm_spmm_plain(m, xd, w_ref * m.weights)
    torch.cuda.synchronize()
    assert segmm_weighted_raw.launches == before + 2
    _close(got, ref)
    assert torch.equal(got, again)
    assert not got[3 * 128:4 * 128].any()


@pytest.mark.parametrize("feat,aligned", SEGMM_SHAPES)
def test_k6_kernel_matches_plain(cuda, feat, aligned):
    _, m, xd, w_edge = _segmm_inputs(cuda, feat, aligned, 4)
    before = segmm_weighted_den_raw.launches
    with torch.inference_mode():
        got = segmm_weighted_den_raw(m, w_edge, xd)
        again = segmm_weighted_den_raw(m, w_edge, xd)
        ref = segmm_weighted_den_raw_plain(m, w_edge, xd)
    torch.cuda.synchronize()
    assert segmm_weighted_den_raw.launches == before + 2
    for a, b, c in zip(got, ref, again):
        _close(a, b)
        assert torch.equal(a, c)                   # den has no atomics
        assert not a[3 * 128:4 * 128].any()
    # den against the weight sums in float64
    recv = torch.repeat_interleave(torch.arange(1024, device=cuda),
                                   m.row_ptr.diff())
    den64 = torch.zeros(1024, dtype=torch.float64, device=cuda).index_add_(
        0, recv, w_edge.double() * m.weights.double())
    _close(got[1].double(), den64)


@pytest.mark.parametrize("form", ["k3", "k3w", "k3w_transpose", "k6"])
def test_segmm_forms_launch_one_kernel(cuda, form):
    """Each form is one kernel launch and nothing else on the card: the
    runtime weights (and their permutation) are formed inside it."""
    rng, m, xd, w_edge = _segmm_inputs(cuda, 64, True, 5)
    perm = torch.from_numpy(rng.permutation(len(w_edge)).astype(
        np.int32)).to(cuda)
    call = {"k3": lambda: segmm_spmm(m, xd),
            "k3w": lambda: segmm_weighted_raw(m, w_edge, xd),
            "k3w_transpose": lambda: segmm_weighted_raw(m, w_edge, xd, perm),
            "k6": lambda: segmm_weighted_den_raw(m, w_edge, xd)}[form]
    with torch.inference_mode():
        call()                                     # builds the kernel
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "segmm_spmm_kernel" in names[0], names


def _att_inputs(rng, feat, dev):
    """K7's operands on ``_tiles``' tile list (a transpose filler at block
    column 2): sparse presence tiles where nodes 0-9 have no entry, scores,
    the exact row max as the stabilizer (−1e30 for nodes 0-9), features
    and cotangents."""
    rows, cols, nb = _tiles(rng)
    blocks = (rng.random((len(rows), 128, 128)) < 0.05).astype(np.float32)
    blocks[rows == 0, :10, :] = 0.0
    n = nb * 128

    def dev_(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    d = dict(rows=dev_(rows), cols=dev_(cols), blocks=dev_(blocks),
             ssrc=dev_(rng.standard_normal(n).astype(np.float32)),
             sdst=dev_(rng.standard_normal(n).astype(np.float32)),
             x=dev_(rng.standard_normal((n, feat)).astype(np.float32)),
             g=dev_(rng.standard_normal((n, feat)).astype(np.float32)),
             dden=dev_(rng.standard_normal(n).astype(np.float32)))
    plan = build_dyn_plan(rows, cols, nb).to(dev)
    d["m"] = att_bsr.att_rowmax_plain(d["rows"], d["cols"], plan,
                                      d["blocks"], d["ssrc"], d["sdst"], 0.2)
    return plan, d


@pytest.mark.parametrize("feat", [16, 101, 128, 512])
def test_k7_kernels_match_plain(cuda, feat):
    rng = np.random.default_rng(feat + 5)
    plan, d = _att_inputs(rng, feat, cuda)
    fwd = (d["rows"], d["cols"], plan, d["blocks"], d["ssrc"], d["sdst"])
    bwd = (plan, d["blocks"], d["ssrc"], d["sdst"], d["m"], d["g"], d["x"],
           d["dden"], 0.2)
    counted = (att_bsr.att_rowmax, att_bsr.att_fwd, att_bsr.att_bwd_t,
               att_bsr.att_bwd_scores, att_bsr.att_sums)
    before = [f.launches for f in counted]
    with torch.inference_mode():
        rm = att_bsr.att_rowmax(*fwd, 0.2)
        num, den = att_bsr.att_fwd(*fwd, d["m"], d["x"], 0.2)
        dx, dssrc = att_bsr.att_bwd_t(*bwd)
        none, dssrc1 = att_bsr.att_bwd_t(*bwd, need_dx=False)
        dsdst = att_bsr.att_bwd_f(d["rows"], d["cols"], *bwd)
        dssrc2, dsdst2 = att_bsr.att_bwd_scores(d["rows"], d["cols"], *bwd)
        num_p, den_p = att_bsr.att_fwd_plain(*fwd, d["m"], d["x"], 0.2)
        dx_p, dssrc_p = att_bsr.att_bwd_t_plain(*bwd)
        dsdst_p = att_bsr.att_bwd_f_plain(d["rows"], d["cols"], *bwd)
    torch.cuda.synchronize()
    after = [f.launches for f in counted]
    # the dx walk once; every dssrc or dsdst asked for is one score pass
    # and one sum of its partials
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 4, 4]
    assert torch.equal(rm, d["m"])               # the same f32 operations
    assert (rm[:10] == -1e30).all() and none is None
    for got, ref in ((num, num_p), (den, den_p), (dx, dx_p),
                     (dssrc, dssrc_p), (dssrc1, dssrc_p), (dsdst, dsdst_p),
                     (dssrc2, dssrc_p), (dsdst2, dsdst_p)):
        _close(got, ref)
    assert not num[:10].any() and not dx[2 * 128:3 * 128].any()


# forward tiles of the score pass's card test: block row 1 has 7 tiles,
# block column 7 one (in row 1), block column 2 none (a transpose filler),
# block row 7 none (dsdst written as 0)
_SCORE_ROWS = [0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 3, 3, 4, 5, 6, 6]
_SCORE_COLS = [0, 1, 0, 1, 3, 4, 5, 6, 7, 3, 0, 4, 1, 5, 3, 6]


def _score_operands(rng, feat, dev, full):
    """Tiles of 3% fill (tile 2, block row 1 against column 0, full when
    ``full``) with positive values at the mask; nodes 0-9 have no entry,
    so their ``m`` (the exact row max) is −1e30; scores, features and
    cotangents unit normal."""
    nb = 8
    rows = np.asarray(_SCORE_ROWS, np.int32)
    cols = np.asarray(_SCORE_COLS, np.int32)
    mask = rng.random((len(rows), 128, 128)) < 0.03
    if full:
        mask[2] = True
    mask[0, :10] = mask[1, :10] = False
    blocks = np.where(mask, rng.random(mask.shape) + 0.5, 0.0)
    n = nb * 128

    def dev_(a, dtype=np.float32):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    d = dict(rows=dev_(rows, np.int32), cols=dev_(cols, np.int32),
             blocks=dev_(blocks),
             ssrc=dev_(rng.standard_normal(n)),
             sdst=dev_(rng.standard_normal(n)),
             x=dev_(rng.standard_normal((n, feat))),
             g=dev_(rng.standard_normal((n, feat))),
             dden=dev_(rng.standard_normal(n)))
    plan = build_dyn_plan(rows, cols, nb).to(dev)
    assert 0 in plan.t_scale.tolist()            # the filler of column 2
    d["m"] = att_bsr.att_rowmax_plain(d["rows"], d["cols"], plan,
                                      d["blocks"], d["ssrc"], d["sdst"], 0.2)
    return plan, d


@pytest.mark.parametrize("feat", [16, 101, 128, 512])
@pytest.mark.parametrize("case", ["sparse", "full", "inf_unreached",
                                  "inf_reached", "deterministic"])
def test_k7_score_pass_matches_plain(cuda, case, feat):
    """K7's score-gradient pass and its partials' sums (``att_bwd_scores``)
    against
    the JAX package's two halves in their plain versions.  ``inf_unreached``:
    an inf in ``g`` at a row without entries and in ``x`` at a column that
    no entry reaches stays out of both sums.  ``inf_reached``: an inf in
    ``g`` at a row with entries gives NaN (the 3xTF32 split's inf − inf)
    exactly where the plain version is not finite (±inf or NaN), the
    recorded divergence.  ``deterministic``: two launches are bit-equal."""
    rng = np.random.default_rng(feat + 30)
    plan, d = _score_operands(rng, feat, cuda, full=case == "full")
    if case == "inf_unreached":
        d["g"][3, 0] = float("inf")                # node 3 has no entry
        # column 5 of block 7 is reached only through tile 8 (row 1)
        d["blocks"][8, :, 5] = 0.0
        d["x"][7 * 128 + 5, feat // 2] = float("-inf")
    if case == "inf_reached":
        i = 3 * 128 + int(torch.nonzero(d["blocks"][10].sum(1))[0])
        d["g"][i, feat - 1] = float("inf")
    args = (d["rows"], d["cols"], plan, d["blocks"], d["ssrc"], d["sdst"],
            d["m"], d["g"], d["x"], d["dden"], 0.2)
    before = (att_bsr.att_bwd_scores.launches, att_bsr.att_sums.launches)
    with torch.inference_mode():
        got = att_bsr.att_bwd_scores(*args)
        again = att_bsr.att_bwd_scores(*args)
        ref = att_bsr.att_bwd_scores_plain(*args)
    torch.cuda.synchronize()
    assert (att_bsr.att_bwd_scores.launches,
            att_bsr.att_sums.launches) == (before[0] + 2, before[1] + 2)
    for a, b in zip(got, again):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
        assert torch.equal(a.isnan(), b.isnan())
    if case == "inf_reached":
        for a, b in zip(got, ref):
            bad = ~torch.isfinite(b)
            assert bad.any() and torch.equal(a.isnan(), bad)
            _close(a[~bad], b[~bad])
        return
    for a, b in zip(got, ref):
        _close(a, b)
    dssrc, dsdst = got
    assert not dsdst[:10].any() and not dsdst[7 * 128:].any()
    assert not dssrc[2 * 128:3 * 128].any()      # no tile in column 2


@pytest.mark.parametrize("feat", [0, 520])
def test_k7_score_pass_refuses_width(cuda, feat):
    rng = np.random.default_rng(7)
    plan, d = _score_operands(rng, max(feat, 1), cuda, full=False)
    g = torch.zeros((d["x"].shape[0], feat), device=cuda)
    with pytest.raises(ValueError, match=f"F={feat}"):
        att_bsr.att_bwd_scores(d["rows"], d["cols"], plan, d["blocks"],
                               d["ssrc"], d["sdst"], d["m"], g, g.clone(),
                               d["dden"], 0.2)


def _grads(model, g, y, mask):
    model.zero_grad(set_to_none=True)
    loss = masked_nll(model(g.x, g), y, mask)
    loss.backward()
    return loss.detach().cpu(), {k: p.grad.detach().cpu()
                                 for k, p in model.named_parameters()}


@pytest.mark.parametrize("layer,hidden", [("GCNConv", 64), ("GATConv", 64),
                                          ("GATConv", 256)])
def test_training_gradients_on_card_match_cpu(cuda, layer, hidden):
    """One training step's loss and gradients with the kernels on the card
    against the plain versions on the CPU (at hidden 64 GAT's stragglers
    take K3w, at 256 the den-column scatter)."""
    rng = np.random.default_rng(9)
    n, feat = 1500, 128
    r = rng.integers(0, n, 15_000)
    s = np.where(rng.random(15_000) < 0.85,
                 np.minimum((r // 128) * 128 + rng.integers(0, 128, 15_000),
                            n - 1), rng.integers(0, n, 15_000))
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = rng.integers(0, 5, n)
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=rng.random(n) < .5,
                                 min_block_edges=48, layer_name=layer)
    assert g.aux.bsr is not None and g.aux.num_coo_edges > 1
    model = NodeModel(layer, feat, hidden, 2, 5, dropout_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0)).train()
    loss_c, grads_c = _grads(model, g, g.y, g.train_mask)
    gd = g.to(cuda)
    loss_d, grads_d = _grads(model.to(cuda), gd, gd.y, gd.train_mask)
    torch.cuda.synchronize()
    _close(loss_d, loss_c)
    for k, v in grads_c.items():
        _close(grads_d[k], v)


@pytest.mark.parametrize("env", [
    {"FITGNN_GAT_FUSED_TILES": "1", "FITGNN_GAT_SEGMM_DEN": "1"},
    {"FITGNN_GAT_FUSED_TILES": "1", "FITGNN_GAT_GLOBAL_MAX": "0"}])
def test_fused_gat_gradients_on_card_match_cpu(cuda, monkeypatch, env):
    """One GAT training step at hidden 256 through K7 (and K6, or K7's row
    max) on the card against the plain versions on the CPU."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(10)
    n, feat = 1500, 128
    r = rng.integers(0, n, 15_000)
    s = np.where(rng.random(15_000) < 0.85,
                 np.minimum((r // 128) * 128 + rng.integers(0, 128, 15_000),
                            n - 1), rng.integers(0, n, 15_000))
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = rng.integers(0, 5, n)
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=rng.random(n) < .5,
                                 min_block_edges=48, layer_name="GATConv")
    model = NodeModel("GATConv", feat, 256, 2, 5, dropout_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0)).train()
    loss_c, grads_c = _grads(model, g, g.y, g.train_mask)
    gd = g.to(cuda)
    before = att_bsr.att_fwd.launches
    loss_d, grads_d = _grads(model.to(cuda), gd, gd.y, gd.train_mask)
    torch.cuda.synchronize()
    assert att_bsr.att_fwd.launches == before + 2
    _close(loss_d, loss_c)
    for k, v in grads_c.items():
        _close(grads_d[k], v)


_WALKS = {"gridwalk": ({}, bsr_spmm_fwd), "group2": (dict(group=2),
                                                     bsr_spmm_grouped),
          "group3": (dict(group=3), bsr_spmm_grouped),
          "rowwalk": (dict(rowwalk=True), bsr_spmm_rowwalk)}


@pytest.mark.parametrize("feat,aligned", [(16, True), (101, True),
                                          (128, True), (512, True),
                                          (128, False)])
@pytest.mark.parametrize("layout", list(_WALKS))
def test_k2_k9_k10_kernels_match_plain(cuda, layout, feat, aligned):
    """K2, K9 and K10 on their layouts; block row 3 has no tile (K10 has no
    filler there and must write it as 0); F=101 and the unaligned view take
    K10's 4-byte copies."""
    rng = np.random.default_rng(feat + 6)
    n = 1024
    s, r, w = _coo(rng, n, 20_000)
    keep = (r // 128 != 3) & (s // 128 != 3)
    kw, walk = _WALKS[layout]
    b = build_bsr(s[keep], r[keep], w[keep], n, **kw).to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, feat)).astype(
        np.float32)).to(cuda)
    xd = x if aligned else _unaligned(x)
    before = walk.launches
    with torch.inference_mode():
        got = bsr_spmm_raw(b, xd)
        ref = bsr_spmm_plain(b, xd)
    torch.cuda.synchronize()
    assert walk.launches == before + 1
    _close(got, ref)
    assert not got[3 * 128:4 * 128].any()


def _sparse_tiles(rng, k):
    """``k`` tiles at ~3% occupancy whose tile rows and columns 0-9 are
    empty."""
    blocks = np.where(rng.random((k, 128, 128)) < 0.03,
                      rng.standard_normal((k, 128, 128)), 0.0)
    blocks[:, :10, :] = 0.0
    blocks[:, :, :10] = 0.0
    return blocks.astype(np.float32)


_BCSR_WALKS = ("K1", "K2", "K9", "K10")
# K8's four forms: transpose, init
_DIAG_WALKS = {"K8": (False, False), "K8init": (False, True),
               "K8T": (True, False), "K8Tinit": (True, True)}


def _walk_operands(rng, kernel, case):
    """The operands of a non-zero walk, with sparse tiles edited by
    ``case``: one fully dense tile, an all-zero tile inside a run, or a NaN
    entry.
    * K1, K2: the grid-walk BCSR, where block row 3 holds only a zero
      coverage filler;
    * K9: the group-padded BCSR (group 3: every run gains zero pads);
    * K10: the row-walk BCSR, where block row 3 has no tile (no filler);
    * K4: a sorted tile list whose block row 4 holds only a zero-valued
      coverage filler, with its dynamic plan;
    * K4ᵀ: a tile list with its transpose plan (block column 2 unused: a
      scale-0 filler slot there);
    * K8: six diagonal blocks, block 4 all zero (as one of the bench
      graph's), and block 1 the one the case edits.
    Returns the operands, the output block of the dense tile (None unless
    "dense"), the output row the NaN must reach (None unless "nan") and
    the output block that no non-zero reaches, which comes out as zeros,
    or as ``init`` for K1 and K8 with init (None for K9)."""
    rows_walk = kernel not in ("K4T", "K8T", "K8Tinit")
    zero_block = None
    if kernel in _DIAG_WALKS:
        blocks = _sparse_tiles(rng, 6)
        blocks[4] = 0.0
        rows = cols = np.arange(6)
        tile, zero_block, plan, b = 1, 4, None, None
    elif kernel in _BCSR_WALKS:
        s, r, w = _coo(rng, 1024, 6_000)
        kw = {"K9": dict(group=3), "K10": dict(rowwalk=True)}.get(kernel,
                                                                  {})
        if kernel != "K9":
            zero_block = 3
            keep = r // 128 != zero_block
            s, r, w = s[keep], r[keep], w[keep]
        b = build_bsr(s, r, w, 1024, with_transpose=False, **kw)
        lo, hi = (int(v) for v in b.row_splits[:2])
        blocks = _sparse_tiles(rng, b.nnz_blocks)
        blocks[~b.blocks.flatten(1).any(1).numpy()] = 0.0  # the pads
        rows, cols, plan = b.rows.numpy(), b.cols.numpy(), None
    else:
        rows, cols, nb = _tiles(rng, nb=6, k=15)
        if kernel == "K4":
            # block row 4 keeps one tile, a coverage filler: column 0, zero
            zero_block = 4
            first = int(np.searchsorted(rows, zero_block))
            keep = (rows != zero_block) | (np.arange(len(rows)) == first)
            rows, cols = rows[keep], cols[keep]
            cols[first] = 0
        else:
            zero_block = 2
        plan = build_dyn_plan(rows, cols, nb)
        splits = (plan.row_splits if kernel == "K4"
                  else plan.t_row_splits).numpy()
        run = int(np.argmax(np.diff(splits)))
        lo, hi = int(splits[run]), int(splits[run + 1])
        blocks = _sparse_tiles(rng, len(rows))
        if kernel == "K4":
            blocks[first] = 0.0
    if kernel not in _DIAG_WALKS:
        assert hi - lo >= 2
        slot = lo if kernel == "K4T" else lo + 1
        tile = int(plan.t_sel[slot]) if kernel == "K4T" else slot
    dense_block = nan_row = None
    if case == "dense":
        blocks[tile] = rng.random((128, 128)) + 0.5
        dense_block = rows[tile] if rows_walk else cols[tile]
    elif case == "zero_inside":
        blocks[tile] = 0.0
    elif case == "nan":
        tile = len(rows) - 1 if kernel == "K4T" else tile
        blocks[tile, 20, 30] = np.nan
        nan_row = (rows[tile] * 128 + 20 if rows_walk
                   else cols[tile] * 128 + 30)
    if kernel in _DIAG_WALKS:
        return torch.from_numpy(blocks), dense_block, nan_row, zero_block
    if plan is None:
        b.blocks = torch.from_numpy(blocks)
        return b, dense_block, nan_row, zero_block
    ops = (torch.from_numpy(rows), torch.from_numpy(cols), plan,
           torch.from_numpy(blocks))
    return ops, dense_block, nan_row, zero_block


_NONZERO_WALKS = {"K1": (bsr_spmm_acc, bsr_spmm_acc_plain),
                  "K2": (bsr_spmm_fwd, bsr_spmm_plain),
                  "K9": (bsr_spmm_grouped, bsr_spmm_plain),
                  "K10": (bsr_spmm_rowwalk, bsr_spmm_plain),
                  "K4": (dyn_tiles, dyn_tiles_plain),
                  "K4T": (dyn_tiles_t, dyn_tiles_t_plain),
                  **{k: (diag_spmm, diag_spmm_plain) for k in _DIAG_WALKS}}


@pytest.mark.parametrize("feat,aligned", [(16, True), (40, True),
                                          (64, True), (101, True),
                                          (512, True), (64, False)])
@pytest.mark.parametrize("case", ["sparse", "dense", "zero_inside", "nan"])
@pytest.mark.parametrize("kernel", ["K9", "K4T", "K10", "K4", "K1", "K2",
                                    *_DIAG_WALKS])
def test_nonzero_walks_match_plain(cuda, kernel, case, feat, aligned):
    """K1, K2, K9, K10, K4, K4ᵀ and K8 (forward and transposed, from init
    and from zero) walk each tile's non-zeros: ~3% occupancy with empty
    tile rows and columns, a fully dense tile, an all-zero tile inside a
    run (beside the zero coverage filler of K1, K2 and K4, K9's pads,
    K10's block row without tiles, K4ᵀ's scale-0 filler and K8's empty
    diagonal block, whose output blocks must come out as 0, or as init for
    K1 and K8 with init, bit for bit), F that is not a multiple of 64 or of
    4, an unaligned x, and a NaN tile entry, which must reach its output
    row and no other."""
    rng = np.random.default_rng(feat + 8)
    ops, dense_block, nan_row, zero_block = _walk_operands(rng, kernel,
                                                           case)
    n = 1024 if kernel in _BCSR_WALKS else 6 * 128
    x = torch.from_numpy(rng.standard_normal((n, feat)).astype(
        np.float32)).to(cuda)
    xd = x if aligned else _unaligned(x)
    walk, plain = _NONZERO_WALKS[kernel]
    base = torch.zeros_like(x)           # what rows without a non-zero get
    if kernel in _DIAG_WALKS:
        transpose, with_init = _DIAG_WALKS[kernel]
        if with_init:
            base = torch.from_numpy(rng.standard_normal((n, feat)).astype(
                np.float32)).to(cuda)
        args = (ops.to(cuda), xd, 3, transpose, base if with_init else None)
    elif kernel in _BCSR_WALKS:
        args = (ops.to(cuda), xd)
        if kernel == "K1":
            base = torch.from_numpy(rng.standard_normal((n, feat)).astype(
                np.float32)).to(cuda)
            args += (base,)
    else:
        rows, cols, plan, blocks = ops
        args = (rows.to(cuda), cols.to(cuda), plan.to(cuda),
                blocks.to(cuda), xd)
        if kernel == "K4T":
            args = args[2:]
    before = walk.launches
    with torch.inference_mode():
        got = walk(*args)
        ref = plain(*args)
    torch.cuda.synchronize()
    assert walk.launches == before + 1
    nan = ref.isnan()
    if nan_row is None:
        _close(got, ref)
    else:
        assert nan.any(1).nonzero().flatten().tolist() == [nan_row]
        assert nan[nan_row].all() and torch.equal(got.isnan(), nan)
        keep = ~nan.any(1)
        _close(got[keep], ref[keep])
    if zero_block is not None:
        rows = slice(zero_block * 128, (zero_block + 1) * 128)
        assert torch.equal(got[rows], base[rows])
    # output rows 0-9 of a block take tile rows (K1, K2, K9, K10, K4, K8) or
    # columns (K4ᵀ, K8 transposed) 0-9
    empty = torch.cat([torch.arange(r * 128, r * 128 + 10)
                       for r in range(n // 128) if r != dense_block])
    assert torch.equal(got[empty.to(cuda)], base[empty.to(cuda)])


def _k7_walk_operands(rng, kernel, case, feat):
    """K7's operands on ``_tiles``' tile list, on the CPU, edited by
    ``case``; ``x`` is the walk's slab operand (K7f's features, K7bt's
    cotangent g).  Presence tiles at ~3% where nodes 0-9 have no entry; the
    transpose plan has a scale-0 filler slot (block column 2 is unused);
    ``m`` is the exact row max of the unedited scores, −1e30 where a node
    has no entry.  Cases: a fully set tile, an all-zero tile inside a run,
    a block row without an entry (every m there −1e30), an inf in ``x`` at
    a row that only masked-out entries reach (K7f: a forward column, K7bt:
    a forward row), and a NaN in ``ssrc`` at one masked entry.  Returns the
    operands and the row of the inf or the output row of the NaN."""
    rows, cols, nb = _tiles(rng)
    plan = build_dyn_plan(rows, cols, nb)
    blocks = (rng.random((len(rows), 128, 128)) < 0.03).astype(np.float32)
    blocks[rows == 0, :10, :] = 0.0
    n = nb * 128
    splits = (plan.row_splits if kernel == "K7f"
              else plan.t_row_splits).numpy()
    lo = int(splits[int(np.argmax(np.diff(splits)))])
    tile = lo + 1 if kernel == "K7f" else int(plan.t_sel[lo])
    row = None
    if case == "dense":
        blocks[tile] = 1.0
    elif case == "zero_inside":
        blocks[tile] = 0.0
    elif case == "edgeless":
        blocks[rows == 4] = 0.0
    elif case == "inf_unreached" and kernel == "K7f":
        blocks[cols == cols[tile], :, 50] = 0.0
        row = cols[tile] * 128 + 50
    elif case == "inf_unreached":
        blocks[rows == rows[tile], 50, :] = 0.0
        row = rows[tile] * 128 + 50
    elif case == "nan":
        if kernel == "K7f":                 # the one entry of its column
            blocks[cols == cols[tile], :, 30] = 0.0
        blocks[tile, 20, 30] = 1.0
        row = (rows[tile] * 128 + 20 if kernel == "K7f"
               else cols[tile] * 128 + 30)
    ops = {k: torch.from_numpy(v) for k, v in dict(
        rows=rows, cols=cols, blocks=blocks,
        ssrc=rng.standard_normal(n).astype(np.float32),
        sdst=rng.standard_normal(n).astype(np.float32),
        x=rng.standard_normal((n, feat)).astype(np.float32),
        x_other=rng.standard_normal((n, feat)).astype(np.float32),
        dden=rng.standard_normal(n).astype(np.float32)).items()}
    ops["m"] = att_bsr.att_rowmax_plain(ops["rows"], ops["cols"], plan,
                                        ops["blocks"], ops["ssrc"],
                                        ops["sdst"], 0.2)
    if case == "inf_unreached":
        ops["x"][row] = float("inf")
    elif case == "nan":
        ops["ssrc"][cols[tile] * 128 + 30] = float("nan")
    return plan, ops, row


@pytest.mark.parametrize("feat", [16, 101, 512])
@pytest.mark.parametrize("case", ["sparse", "dense", "zero_inside",
                                  "edgeless", "inf_unreached", "nan"])
@pytest.mark.parametrize("kernel", ["K7f", "K7bt"])
def test_k7_walks_match_plain(cuda, kernel, case, feat):
    """K7f (``num`` and ``den``) and K7bt's ``dx`` walk each tile's
    non-zeros with ``pe`` worked out per non-zero: ~3% occupancy, a fully
    set tile, an all-zero tile inside a run, a block row whose nodes have
    no edge (m = −1e30), the transpose plan's scale-0 filler, F that is not
    a multiple of 4 (the 4-byte slab copy) and F=512 (four slices, ``den``
    from the first); every output row that no entry reaches is written as
    0.  An inf in x (K7f) or g (K7bt) at a row that only masked-out entries
    reach leaves the kernel's output finite, where the plain version gives
    0·inf = NaN (the walk's divergence): the kernel must equal the plain
    version on the same operands with that row zeroed.  A NaN in ssrc at a
    masked entry reaches its own output row and no other."""
    rng = np.random.default_rng(feat + 30)
    plan, ops, row = _k7_walk_operands(rng, kernel, case, feat)
    plan = plan.to(cuda)
    d = {k: v.to(cuda) for k, v in ops.items()}
    if kernel == "K7f":
        fwd = (d["rows"], d["cols"], plan, d["blocks"], d["ssrc"], d["sdst"],
               d["m"])

        def run(fn, x):
            num, den = fn(*fwd, x, 0.2)
            return torch.cat([num, den[:, None]], 1)

        walk, plain = att_bsr.att_fwd, att_bsr.att_fwd_plain
    else:
        def run(fn, g):
            return fn(plan, d["blocks"], d["ssrc"], d["sdst"], d["m"], g,
                      d["x_other"], d["dden"], 0.2, need_dssrc=False)[0]

        walk, plain = att_bsr.att_bwd_t, att_bsr.att_bwd_t_plain
    before = walk.launches
    with torch.inference_mode():
        got = run(walk, d["x"])
        ref = run(plain, d["x"])
        if case == "inf_unreached":
            clean = d["x"].clone()
            clean[row] = 0.0
            ref_clean = run(plain, clean)
    torch.cuda.synchronize()
    assert walk.launches == before + 1
    nan = ref.isnan()
    if case == "inf_unreached":
        assert nan.any()                  # the dense product's 0·inf
        _close(got, ref_clean)
    elif case == "nan":
        assert nan.any(1).nonzero().flatten().tolist() == [row]
        assert nan[row].all() and torch.equal(got.isnan(), nan)
        _close(got[~nan.any(1)], ref[~nan.any(1)])
    else:
        _close(got, ref)
    # output rows that no entry reaches (K7f: forward rows, K7bt: forward
    # columns; the filler's block 2 among them) come out as exact zeros
    reached = torch.zeros(got.shape[0], dtype=torch.bool)
    for k in range(len(ops["rows"])):
        hit = ops["blocks"][k].any(1 if kernel == "K7f" else 0)
        blk = int((ops["rows"] if kernel == "K7f" else ops["cols"])[k])
        reached[blk * 128:(blk + 1) * 128] |= hit
    if kernel == "K7bt":
        assert not reached[2 * 128:3 * 128].any()
    assert not got[~reached.to(cuda)].any()


@pytest.mark.parametrize("case", ["nan_init", "init_unaligned",
                                  "x_unaligned", "feat101"])
def test_k1_walk_starts_from_init(cuda, case):
    """K1 loads ``init`` into its accumulators: a NaN in init reaches its
    own element and no other; init and x each take their own 16-byte or
    4-byte path (an unaligned init beside an aligned x, the reverse, and
    F=101, where both take the 4-byte path); block row 3, whose only tile
    is a zero coverage filler, and the tile rows without a non-zero come
    out as init, bit for bit."""
    rng = np.random.default_rng(13)
    feat = 101 if case == "feat101" else 64
    b, _, _, zero_block = _walk_operands(rng, "K1", "sparse")
    n = 1024
    x, init = (torch.from_numpy(rng.standard_normal((n, feat)).astype(
        np.float32)).to(cuda) for _ in range(2))
    if case == "nan_init":
        init[300, 7] = float("nan")
    init = _unaligned(init) if case == "init_unaligned" else init
    x = _unaligned(x) if case == "x_unaligned" else x
    b = b.to(cuda)
    before = bsr_spmm_acc.launches
    with torch.inference_mode():
        got = bsr_spmm_acc(b, x, init)
        ref = bsr_spmm_acc_plain(b, x, init)
    torch.cuda.synchronize()
    assert bsr_spmm_acc.launches == before + 1
    nan = got.isnan()
    assert nan.nonzero().tolist() == ([[300, 7]] if case == "nan_init"
                                      else [])
    assert torch.equal(nan, ref.isnan())
    _close(got[~nan], ref[~nan])
    rows = slice(zero_block * 128, (zero_block + 1) * 128)
    assert torch.equal(got[rows], init[rows])
    empty = torch.cat([torch.arange(r * 128, r * 128 + 10)
                       for r in range(n // 128)]).to(cuda)
    assert torch.equal(got[empty], init[empty])


# F=101 and the unaligned x take the walk's 4-byte slab copy
@pytest.mark.parametrize("feat,aligned", [(16, True), (101, True),
                                          (512, True), (64, False)])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
def test_k8_kernel_matches_plain(cuda, transpose, with_init, feat, aligned):
    """K8 on ~10% full diagonal blocks; block 2 is all zero, so its output
    rows come out as init (or zero) bit for bit."""
    rng = np.random.default_rng(feat + 7)
    nb = 6
    blocks = (rng.standard_normal((nb, 128, 128))
              * (rng.random((nb, 128, 128)) < 0.1)).astype(np.float32)
    blocks[2] = 0.0
    blocks = torch.from_numpy(blocks).to(cuda)
    x, init = (torch.from_numpy(rng.standard_normal((nb * 128, feat)).astype(
        np.float32)).to(cuda) for _ in range(2))
    x = x if aligned else _unaligned(x)
    init = init if with_init else None
    before = diag_spmm.launches
    with torch.inference_mode():
        got = diag_spmm(blocks, x, 3, transpose, init)
        ref = diag_spmm_plain(blocks, x, 3, transpose, init)
    torch.cuda.synchronize()
    assert diag_spmm.launches == before + 1
    _close(got, ref)
    zero = got[2 * 128:3 * 128]
    assert (torch.equal(zero, init[2 * 128:3 * 128]) if with_init
            else not zero.any())


@pytest.mark.parametrize("shape,aligned", [((1000, 512), True),
                                           ((37, 101), True),
                                           ((64, 128), False)])
@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_k11_kernel_matches_plain_bit_exact(cuda, shape, aligned, rate):
    """The kernel's Philox bits and keep rule equal the plain version's:
    outputs equal exactly (an odd element count takes the scalar tail)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda)
    x = x if aligned else _unaligned(x)
    seed = dropout_mod.seed_from_generator(gen, cuda)
    before = philox_dropout.launches
    with torch.inference_mode():
        got = philox_dropout(x, seed, rate)
        ref = philox_dropout_plain(x, seed, rate)
    torch.cuda.synchronize()
    assert philox_dropout.launches == before + 1
    assert torch.equal(got, ref)


def _bench_like(rng, n=1500, e=15_000):
    r = rng.integers(0, n, e)
    s = np.where(rng.random(e) < 0.85,
                 np.minimum((r // 128) * 128 + rng.integers(0, 128, e),
                            n - 1), rng.integers(0, n, e))
    return s, r


@pytest.mark.parametrize("case", ["diag", "group2", "rowwalk"])
def test_opt_in_training_on_card_matches_cpu(cuda, case):
    """One GCN training step (hidden 64, dropout off) on each opt-in
    operator, kernels on the card against plain versions on the CPU, with
    the operator's own walk launched four times (at 128 → 64 layer 0
    aggregates ``lin(x)``, which needs a gradient: two forward, two
    backward)."""
    rng = np.random.default_rng(11)
    s, r = _bench_like(rng)
    n, feat = 1500, 128
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = rng.integers(0, 5, n)
    kw = {"diag": dict(use_diag=True), "group2": dict(tile_group=2),
          "rowwalk": {}}[case]
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=rng.random(n) < .5,
                                 min_block_edges=48, **kw)
    if case == "rowwalk":
        h = build_hybrid(g.senders.numpy(), g.receivers.numpy(),
                         g.edge_weight.numpy(), g.num_nodes_padded,
                         min_block_edges=48, use_segmm=True,
                         use_rowwalk=True)
        g = g._replace(aux=h)
    walk = {"diag": diag_spmm, "group2": bsr_spmm_grouped,
            "rowwalk": bsr_spmm_rowwalk}[case]
    model = NodeModel("GCNConv", feat, 64, 2, 5, dropout_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0)).train()
    loss_c, grads_c = _grads(model, g, g.y, g.train_mask)
    gd = g.to(cuda)
    before = walk.launches
    loss_d, grads_d = _grads(model.to(cuda), gd, gd.y, gd.train_mask)
    torch.cuda.synchronize()
    assert walk.launches == before + 4
    _close(loss_d, loss_c)
    for k, v in grads_c.items():
        _close(grads_d[k], v)


def test_fused_dropout_step_on_card(cuda, monkeypatch):
    """A GCN step with ``fused_dropout=True, bit_dropout=False`` launches
    K11 four times (two layers, forward and backward), and the same step
    with the plain Philox version patched in gives the same loss and
    gradients (the same seeds from the same generator)."""
    rng = np.random.default_rng(12)
    s, r = _bench_like(rng)
    n, feat = 1500, 128
    x = rng.standard_normal((n, feat)).astype(np.float32)
    g, _ = build_optimized_graph(x, s, r, y=rng.integers(0, 5, n),
                                 train_mask=rng.random(n) < .5,
                                 min_block_edges=48)
    gd = g.to(cuda)
    model = NodeModel("GCNConv", feat, 64, 2, 5, dropout_rate=0.5,
                      fused_dropout=True, bit_dropout=False)
    model = model.reset_parameters(torch.Generator().manual_seed(0)).to(
        cuda).train()

    def step():
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device=cuda).manual_seed(5)
        loss = masked_nll(model(gd.x, gd, gen), gd.y, gd.train_mask)
        loss.backward()
        return loss.detach(), {k: p.grad.detach().clone()
                               for k, p in model.named_parameters()}

    before = philox_dropout.launches
    loss_k, grads_k = step()
    torch.cuda.synchronize()
    assert philox_dropout.launches == before + 4
    monkeypatch.setattr(dropout_mod, "philox_dropout", philox_dropout_plain)
    loss_p, grads_p = step()
    _close(loss_k, loss_p)
    for k, v in grads_p.items():
        _close(grads_k[k], v)
