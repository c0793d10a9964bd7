"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels build at
first use) and skips without one; ``chip_smoke.py`` runs the same checks on
the card at the bench graph's shapes.  Tolerance: rtol 1e-4 and atol
1e-4·max|ref|, f32 sums taken in another order; training gradients on the
card are held against the plain versions on the CPU the same way.
"""

import dataclasses

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
                                           bsr_spmm_raw, bsr_spmm_rowwalk,
                                           quad_words)
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


def _layer_operator(rng, layer, **kw):
    """The hybrid operator ``build_optimized_graph`` gives ``layer`` on a
    1,500-node community graph: SAGE's ``1/indeg`` weights make it
    asymmetric, GIN's are 0/1."""
    s, r = _bench_like(rng)
    x = np.zeros((1500, 4), np.float32)
    g, _ = build_optimized_graph(x, s, r, min_block_edges=48,
                                 layer_name=layer, **kw)
    h = g.aux
    assert h.bsr is not None or h.diag_blocks is not None
    return h


@pytest.mark.parametrize("feat", [128, 512])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("layer", ["SAGEConv", "GINConv"])
def test_k1_k3_at_sage_gin_weights_match_plain(cuda, layer, transpose,
                                                feat):
    """K3 then K1 on the SAGE (``mean_nonself``) and GIN (``sum_nonself``)
    operators, forward and on the transpose structures (``t_segmm``,
    ``bsr.transpose``) the backward runs, against the plain versions."""
    rng = np.random.default_rng(feat + len(layer))
    h = _layer_operator(rng, layer).to(cuda)
    m = h.t_segmm if transpose else h.segmm
    b = h.bsr.transpose if transpose else h.bsr
    x = torch.from_numpy(rng.standard_normal((h.num_nodes, feat)).astype(
        np.float32)).to(cuda)
    before = (segmm_spmm.launches, bsr_spmm_acc.launches)
    with torch.inference_mode():
        k3, p3 = segmm_spmm(m, x), segmm_spmm_plain(m, x)
        k1, p1 = bsr_spmm_acc(b, x, p3), bsr_spmm_acc_plain(b, x, p3)
    torch.cuda.synchronize()
    assert (segmm_spmm.launches, bsr_spmm_acc.launches) == (
        before[0] + 1, before[1] + 1)
    _close(k3, p3)
    _close(k1, p1)


@pytest.mark.parametrize("transpose", [False, True])
def test_k8_on_sage_diagonal_matches_plain(cuda, transpose):
    """K8 from ``init`` on the diagonal blocks of SAGE's ``use_diag``
    operator, which are not symmetric, in both orientations."""
    rng = np.random.default_rng(13)
    h = _layer_operator(rng, "SAGEConv", use_diag=True).to(cuda)
    blocks = h.diag_blocks
    assert not torch.equal(blocks, blocks.transpose(1, 2))
    x, init = (torch.from_numpy(rng.standard_normal(
        (h.num_nodes, 512)).astype(np.float32)).to(cuda) for _ in range(2))
    with torch.inference_mode():
        got = diag_spmm(blocks, x, h.diag_r, transpose, init)
        ref = diag_spmm_plain(blocks, x, h.diag_r, transpose, init)
    torch.cuda.synchronize()
    _close(got, ref)


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


# --- occupancy words in GAT's plan: K4 and K4ᵀ over the live quadrants ----

def _dynwords_operands(rng, edge):
    """K4's and K4ᵀ's operands on ``edge``-wide tiles (four tile rows): a
    sorted tile list covering every tile row whose tile column 2 is never
    used (the transpose plan's scale-0 filler slot); a 0/1 mask ~3% full
    with each 128-wide quadrant empty at odds 0.4 and quadrant (0, 1) of
    every tile empty; the plan with the mask's occupancy words; and
    ``pe``-like values, positive on the mask and zero elsewhere."""
    nb, nq = 4, edge // 128
    rows = np.sort(np.concatenate([np.arange(nb), rng.integers(0, nb, 8)]))
    cols = rng.choice([0, 1, 3], len(rows))
    k = len(rows)
    empty = rng.random((k, nq, nq)) < 0.4
    empty[:, 0, 1] = True
    mask = (rng.random((k, edge, edge)) < 0.03) & ~np.repeat(np.repeat(
        empty, 128, 1), 128, 2)
    mask = torch.from_numpy(mask.astype(np.float32))
    plan = build_dyn_plan(rows, cols, nb, words=quad_words(mask, edge),
                          block=edge)
    assert plan.t_scale.numpy().tolist().count(0) == 1
    pe = torch.where(mask > 0, torch.from_numpy(
        rng.random((k, edge, edge)).astype(np.float32)) + 0.1, 0.0)
    return (torch.from_numpy(rows.astype(np.int32)),
            torch.from_numpy(cols.astype(np.int32)), plan, pe)


def _dynwords_walk(kernel, rows, cols, pe, x):
    """K4 (``dyn_tiles``) or K4ᵀ (``dyn_tiles_t``) on a plan: (the walk,
    the plain version)."""
    if kernel == "K4":
        return (lambda plan: dyn_tiles(rows, cols, plan, pe, x),
                lambda plan: dyn_tiles_plain(rows, cols, plan, pe, x))
    return (lambda plan: dyn_tiles_t(plan, pe, x),
            lambda plan: dyn_tiles_t_plain(plan, pe, x))


def _no_words(plan):
    return dataclasses.replace(plan, words=None, t_words=None)


@pytest.mark.parametrize("feat,aligned", [(40, True), (40, False),
                                          (128, True), (512, True)])
@pytest.mark.parametrize("edge", [256, 512])
@pytest.mark.parametrize("kernel", ["K4", "K4T"])
def test_dynwords_walks_match_plain(cuda, kernel, edge, feat, aligned):
    """K4 and K4ᵀ with the plan's occupancy words (the live quadrants
    alone, each one's slab copy started with its tile read; K4ᵀ by the
    transposed words, its filler slot's word 0) on ``pe``-like values at
    edges 256 and 512: against their plain versions (at F=40 on an
    unaligned x, the 4-byte slab copy), and bit for bit the walk without
    words, which reads and votes on every quadrant; each walk counts one
    launch."""
    rng = np.random.default_rng(edge + feat + 240)
    rows, cols, plan, pe = _dynwords_operands(rng, edge)
    x = torch.from_numpy(rng.standard_normal((4 * edge, feat)).astype(
        np.float32)).to(cuda)
    walk, plain = _dynwords_walk(kernel, rows.to(cuda), cols.to(cuda),
                                 pe.to(cuda), x if aligned else _unaligned(x))
    plan = plan.to(cuda)
    count = dyn_tiles if kernel == "K4" else dyn_tiles_t
    before = count.launches
    with torch.inference_mode():
        got = walk(plan)
        ref = plain(plan)
        without = walk(_no_words(plan))
    torch.cuda.synchronize()
    assert count.launches == before + 2
    _close(got, ref)
    assert torch.equal(got, without)


@pytest.mark.parametrize("kernel", ["K4", "K4T"])
def test_dynwords_value_only_an_empty_quadrant_holds(cuda, kernel):
    """The walk's divergence from the dense product (``ROADMAP.md`` §3): a
    value in a quadrant whose bit is clear (entry (5, 200) of tile 1, in
    its quadrant (0, 1), empty in the mask) is dropped by the walk with
    words, which gives the walk of the values without it bit for bit; the
    plain version (the dense product, as the JAX package's) and the walk
    without words keep it, in its output row alone."""
    rng = np.random.default_rng(251)
    rows, cols, plan, pe = _dynwords_operands(rng, 256)
    assert not (int(plan.words[1]) >> 1) & 1
    stray = pe.clone()
    stray[1, 5, 200] = 3.0
    row = (int(rows[1]) * 256 + 5 if kernel == "K4"
           else int(cols[1]) * 256 + 200)
    x = torch.from_numpy(rng.standard_normal((1024, 128)).astype(
        np.float32)).to(cuda)
    plan = plan.to(cuda)
    rows, cols = rows.to(cuda), cols.to(cuda)
    walk, plain = _dynwords_walk(kernel, rows, cols, stray.to(cuda), x)
    clean, _ = _dynwords_walk(kernel, rows, cols, pe.to(cuda), x)
    with torch.inference_mode():
        got, ref = walk(plan), plain(plan)
        without, want = walk(_no_words(plan)), clean(plan)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _close(without, ref)
    moved = (got - ref).abs().amax(1) > 1e-3 * float(ref.abs().max())
    assert moved.nonzero().flatten().tolist() == [row]


def test_dynwords_refused_where_the_walk_has_no_words(cuda):
    """Words on 128-wide tiles (which no plan builder makes) raise: the
    entry has no words form at 128, and there is no fallback to the walk
    without them."""
    rows = torch.tensor([0, 1], dtype=torch.int32)
    cols = torch.tensor([1, 0], dtype=torch.int32)
    plan = build_dyn_plan(rows.numpy(), cols.numpy(), 2)
    plan.words = torch.full((2,), -1, dtype=torch.int64)
    plan.t_words = plan.words.clone()
    plan = plan.to(cuda)
    blocks = torch.ones((2, 128, 128), device=cuda)
    x = torch.ones((256, 8), device=cuda)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        dyn_tiles(rows.to(cuda), cols.to(cuda), plan, blocks, x)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        dyn_tiles_t(plan, blocks, x)


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


_PROFILER_WARM = []


@pytest.fixture
def warm_profiler(cuda):
    """A process's first ``torch.profiler.profile`` over CUDA can come back
    without any CUDA event (CUPTI's activity tracing is set up during it),
    so a test that reads a profile's kernels gets one profile before its
    own, once a process: a profile of one kernel, repeated until it sees
    that kernel (at most three times)."""
    if not _PROFILER_WARM:
        for _ in range(3):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                torch.ones(8, device=cuda).add_(1.0)
                torch.cuda.synchronize()
            if any(e.device_type == torch.autograd.DeviceType.CUDA
                   for e in p.events()):
                break
        _PROFILER_WARM.append(True)
    return cuda


@pytest.mark.parametrize("form", ["k3", "k3w", "k3w_transpose", "k6"])
def test_segmm_forms_launch_one_kernel(warm_profiler, form):
    """Each form is one kernel launch and nothing else on the card: the
    runtime weights (and their permutation) are formed inside it."""
    cuda = warm_profiler
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
                                          ("GATConv", 256), ("SAGEConv", 64),
                                          ("GINConv", 64)])
def test_training_gradients_on_card_match_cpu(cuda, layer, hidden):
    """One training step's loss and gradients with the kernels on the card
    against the plain versions on the CPU (at hidden 64 GAT's stragglers
    take K3w, at 256 the den-column scatter; SAGE and GIN run K3 and K1 on
    their mean and sum operators, GIN's 0-dim ``eps`` among the
    gradients)."""
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


# --- bf16 tiles (train --hybrid_bf16_tiles) -------------------------------

_BF16_WALKS = ("K1", "K2", "K9", "K10", *_DIAG_WALKS)


def _bf16_nan_equal(a, b):
    """Bit-equal, NaN where the other is NaN."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


@pytest.mark.parametrize("feat,aligned", [(16, True), (101, True),
                                          (128, True), (512, True),
                                          (64, False)])
@pytest.mark.parametrize("case", ["sparse", "dense", "zero_inside", "nan"])
@pytest.mark.parametrize("kernel", _BF16_WALKS)
def test_bf16_walks_match_plain(cuda, kernel, case, feat, aligned):
    """The walk's bf16 forms of K1, K2, K9, K10 and K8 (both orientations,
    from init and from zero) in the cases of
    ``test_nonzero_walks_match_plain``: against their plain versions on the
    same bf16 tiles; bit for bit against the f32 walk on the tiles widened
    to f32 and x as the form multiplies it (rounded to bf16, except by K10);
    measurably apart from the other rounding rule; the rows that no
    non-zero reaches come out as init or zero; counted in
    ``launches_bf16`` alone."""
    rng = np.random.default_rng(feat + 40)
    ops, dense_block, nan_row, zero_block = _walk_operands(rng, kernel,
                                                           case)
    n = 1024 if kernel in _BCSR_WALKS else 6 * 128
    x = torch.from_numpy(rng.standard_normal((n, feat)).astype(
        np.float32)).to(cuda)
    xd = x if aligned else _unaligned(x)
    rounded = x.to(torch.bfloat16).float()
    walk, plain = _NONZERO_WALKS[kernel]
    base = torch.zeros_like(x)
    if kernel in _DIAG_WALKS:
        transpose, with_init = _DIAG_WALKS[kernel]
        if with_init:
            base = torch.from_numpy(rng.standard_normal((n, feat)).astype(
                np.float32)).to(cuda)
        tiles = ops.to(cuda).to(torch.bfloat16)

        def args(t, xx):
            return (t, xx, 3, transpose, base if with_init else None)

        wide = tiles.float()
    else:
        b = ops.to(cuda)
        if kernel == "K1":
            base = torch.from_numpy(rng.standard_normal((n, feat)).astype(
                np.float32)).to(cuda)

        def args(t, xx):
            return (t, xx) + ((base,) if kernel == "K1" else ())

        tiles = dataclasses.replace(b, blocks=b.blocks.to(torch.bfloat16))
        wide = dataclasses.replace(b, blocks=tiles.blocks.float())
    right, wrong = (x, rounded) if kernel == "K10" else (rounded, x)
    before = (walk.launches, walk.launches_bf16)
    with torch.inference_mode():
        got = walk(*args(tiles, xd))
        ref = plain(*args(tiles, xd))
        f32_walk = walk(*args(wide, right))
        other_rule = plain(*args(wide, wrong))
    torch.cuda.synchronize()
    assert (walk.launches, walk.launches_bf16) == (before[0] + 1,
                                                   before[1] + 1)
    assert _bf16_nan_equal(got, f32_walk)
    nan = ref.isnan()
    if nan_row is None:
        _close(got, ref)
        atol = 1e-4 * float(ref.abs().max())
        assert float((got - other_rule).abs().max()) > 10 * atol
    else:
        assert nan.any(1).nonzero().flatten().tolist() == [nan_row]
        assert torch.equal(got.isnan(), nan)
        keep = ~nan.any(1)
        _close(got[keep], ref[keep])
    if zero_block is not None:
        rows = slice(zero_block * 128, (zero_block + 1) * 128)
        assert torch.equal(got[rows], base[rows])
    empty = torch.cat([torch.arange(r * 128, r * 128 + 10)
                       for r in range(n // 128) if r != dense_block])
    assert torch.equal(got[empty.to(cuda)], base[empty.to(cuda)])


@pytest.mark.parametrize("feat", [16, 101, 128, 512])
@pytest.mark.parametrize("case", ["sparse", "dense", "zero_inside",
                                  "edgeless", "inf_unreached", "nan"])
@pytest.mark.parametrize("kernel", ["K7f", "K7bt"])
def test_bf16_k7_walks_match_f32(cuda, kernel, case, feat):
    """K7f and K7bt's ``dx`` on bf16 masks, in the cases of
    ``test_k7_walks_match_plain``: bit for bit the f32 forms' results on
    the same 0/1 tiles (the mask is exact in bf16, and pe and x stay f32),
    within tolerance of the plain version on the bf16 tiles, with the walk's
    divergence where an inf is reached only by masked-out entries; counted
    in ``launches_bf16`` alone."""
    rng = np.random.default_rng(feat + 50)
    plan, ops, row = _k7_walk_operands(rng, kernel, case, feat)
    plan = plan.to(cuda)
    d = {k: v.to(cuda) for k, v in ops.items()}
    bf = d["blocks"].to(torch.bfloat16)
    if kernel == "K7f":
        def run(fn, blocks, x):
            num, den = fn(d["rows"], d["cols"], plan, blocks, d["ssrc"],
                          d["sdst"], d["m"], x, 0.2)
            return torch.cat([num, den[:, None]], 1)

        walk, plain = att_bsr.att_fwd, att_bsr.att_fwd_plain
    else:
        def run(fn, blocks, g):
            return fn(plan, blocks, d["ssrc"], d["sdst"], d["m"], g,
                      d["x_other"], d["dden"], 0.2, need_dssrc=False)[0]

        walk, plain = att_bsr.att_bwd_t, att_bsr.att_bwd_t_plain
    before = (walk.launches, walk.launches_bf16)
    with torch.inference_mode():
        got = run(walk, bf, d["x"])
        f32 = run(walk, d["blocks"], d["x"])
        x_ref = d["x"]
        if case == "inf_unreached":
            x_ref = d["x"].clone()
            x_ref[row] = 0.0
        ref = run(plain, bf, x_ref)
    torch.cuda.synchronize()
    assert (walk.launches, walk.launches_bf16) == (before[0] + 1,
                                                   before[1] + 1)
    assert _bf16_nan_equal(got, f32)
    if case == "nan":
        keep = ~ref.isnan().any(1)
        assert ref.isnan().any(1).nonzero().flatten().tolist() == [row]
        _close(got[keep], ref[keep])
    else:
        _close(got, ref)


@pytest.mark.parametrize("feat", [16, 101, 128, 512])
@pytest.mark.parametrize("case", ["sparse", "full", "inf_unreached"])
def test_bf16_k7_rowmax_and_score_pass_match_f32(cuda, case, feat):
    """K7rm and the score pass (``att_bwd_scores``, then ``att_sums``) on
    bf16 tiles: only the mask is read, so each equals its f32 form on the
    same tiles bit for bit, and the plain version within tolerance (an inf
    that no entry reaches stays out of the sums); counted in
    ``launches_bf16`` (K7sums, which reads no tile, in ``launches``)."""
    rng = np.random.default_rng(feat + 60)
    plan, d = _score_operands(rng, feat, cuda, full=case == "full")
    if case == "inf_unreached":
        d["g"][3, 0] = float("inf")
        d["blocks"][8, :, 5] = 0.0
        d["x"][7 * 128 + 5, feat // 2] = float("-inf")
    bf = d["blocks"].to(torch.bfloat16)

    def args(blocks):
        return (d["rows"], d["cols"], plan, blocks, d["ssrc"], d["sdst"],
                d["m"], d["g"], d["x"], d["dden"], 0.2)

    fwd = (d["rows"], d["cols"], plan)
    counted = (att_bsr.att_rowmax, att_bsr.att_bwd_scores)
    before = [(f.launches, f.launches_bf16) for f in counted]
    sums = att_bsr.att_sums.launches
    with torch.inference_mode():
        rm = att_bsr.att_rowmax(*fwd, bf, d["ssrc"], d["sdst"], 0.2)
        rm32 = att_bsr.att_rowmax(*fwd, d["blocks"], d["ssrc"], d["sdst"],
                                  0.2)
        got = att_bsr.att_bwd_scores(*args(bf))
        f32 = att_bsr.att_bwd_scores(*args(d["blocks"]))
        ref = att_bsr.att_bwd_scores_plain(*args(bf))
    torch.cuda.synchronize()
    assert [(f.launches, f.launches_bf16) for f in counted] == [
        (a + 1, b + 1) for a, b in before]
    assert att_bsr.att_sums.launches == sums + 2
    assert torch.equal(rm, rm32) and torch.equal(rm, d["m"])
    for a, b, c in zip(got, f32, ref):
        assert _bf16_nan_equal(a, b)
        _close(a, c)


@pytest.mark.parametrize("layer", ["GCNConv", "GATConv"])
@pytest.mark.parametrize("classify", [True, False], ids=["cls", "reg"])
def test_graph_model_on_card_matches_cpu(cuda, layer, classify):
    """``GraphModel``'s Gc view (above 512 coarse nodes: the per-edge
    branch) and Gs view (the dense batched branch) on the card against the
    CPU with the same parameters; no kernel of the port launches."""
    from fitgnn_tpu_torch.data.graph_level import (collate_graph_level,
                                                   prepare_graph_sample)
    from fitgnn_tpu_torch.data.synthetic import qm9_like_dataset
    from fitgnn_tpu_torch.models.models import GraphModel
    from fitgnn_tpu_torch.train.graph_loop import _forward
    graphs, y_reg, y_cls = qm9_like_dataset(128, seed=0)
    y = y_cls if classify else y_reg
    b = collate_graph_level([
        prepare_graph_sample(x, s, r, y_, reduction=0.5, mode="extra_node")
        for (x, s, r), y_ in zip(graphs, y)])
    assert b.gc.num_nodes_padded > 512 and b.gs.num_nodes_padded <= 512
    m = GraphModel(layer, in_dim=11, hidden=512, num_layers=2,
                   out_dim=2 if classify else 1, classify=classify)
    m.reset_parameters(torch.Generator().manual_seed(0)).eval()
    counts = (segmm_spmm.launches, bsr_spmm_acc.launches)
    with torch.inference_mode():
        ref = {v: _forward(m, b, v) for v in ("gc", "gs")}
        mc, bc = m.to(cuda), b.to(cuda)
        got = {v: _forward(mc, bc, v) for v in ("gc", "gs")}
    torch.cuda.synchronize()
    assert (segmm_spmm.launches, bsr_spmm_acc.launches) == counts
    for v in ("gc", "gs"):
        assert got[v].shape == (128, 2 if classify else 1)
        _close(got[v].cpu(), ref[v])


# --- tiles of another edge (block=256): the quadrant walk -------------------

_EDGE = 256
_QUAD_WALKS = ("K1", "K2", "K9", *_DIAG_WALKS)


def _quad_operands(rng, kernel, case):
    """The operands of a walk on 256-wide tiles (1,024 nodes: four tile
    rows), sparse (~3%) with tile rows and columns 0-9 of every 128-wide
    quadrant empty and quadrant (0, 1) of every tile empty, edited by
    ``case``: one fully dense tile, an all-zero tile inside a run, or a NaN
    entry in quadrant (1, 1) (tile row 150, column 200).
    * K1, K2: the grid-walk BCSR; tile row 2 holds only a zero coverage
      filler;
    * K9: the group-padded BCSR (group 3: every run gains zero pads);
    * K8: four diagonal blocks, block 2 all zero, block 1 the one the case
      edits.
    The BCSR's occupancy words are those of the edited tiles.  Returns
    the operands, the 128-row output blocks of the dense tile (empty unless
    "dense"), the output row the NaN must reach (None unless "nan") and the
    256-row output block that no non-zero reaches (None for K9)."""
    rows_walk = kernel not in ("K8T", "K8Tinit")
    zero_block = None
    if kernel in _DIAG_WALKS:
        nt, tile, zero_block, b = 4, 1, 2, None
        rows = cols = np.arange(nt)
    else:
        s, r, w = _coo(rng, 1024, 8_000)
        s = np.where(rng.random(len(s)) < 0.8,
                     (r // _EDGE) * _EDGE + rng.integers(0, _EDGE, len(s)), s)
        if kernel != "K9":
            zero_block = 2
            keep = (r // _EDGE != zero_block) & (s // _EDGE != zero_block)
            s, r, w = s[keep], r[keep], w[keep]
        b = build_bsr(s, r, w, 1024, _EDGE, with_transpose=False,
                      group=3 if kernel == "K9" else 1)
        nt, (lo, hi) = b.nnz_blocks, (int(v) for v in b.row_splits[:2])
        assert hi - lo >= 2
        tile = lo + 1
        rows, cols = b.rows.numpy(), b.cols.numpy()
    blocks = np.where(rng.random((nt, _EDGE, _EDGE)) < 0.03,
                      rng.standard_normal((nt, _EDGE, _EDGE)), 0.0)
    for q in (0, 128):
        blocks[:, q:q + 10, :] = 0.0
        blocks[:, :, q:q + 10] = 0.0
    blocks[:, :128, 128:] = 0.0
    if b is not None:
        blocks[~b.blocks.flatten(1).any(1).numpy()] = 0.0    # the pads
    else:
        blocks[zero_block] = 0.0
    dense_blocks, nan_row = [], None
    if case == "dense":
        blocks[tile] = rng.random((_EDGE, _EDGE)) + 0.5
        c = rows[tile] if rows_walk else cols[tile]
        dense_blocks = [2 * c, 2 * c + 1]
    elif case == "zero_inside":
        blocks[tile] = 0.0
    elif case == "nan":
        blocks[tile, 150, 200] = np.nan
        nan_row = (rows[tile] * _EDGE + 150 if rows_walk
                   else cols[tile] * _EDGE + 200)
    blocks = torch.from_numpy(blocks.astype(np.float32))
    if b is None:
        return blocks, dense_blocks, nan_row, zero_block
    return (dataclasses.replace(b, blocks=blocks), dense_blocks, nan_row,
            zero_block)


@pytest.mark.parametrize("feat,aligned", [(40, True), (128, True),
                                          (512, True), (40, False)])
@pytest.mark.parametrize("case", ["sparse", "dense", "zero_inside", "nan"])
@pytest.mark.parametrize("tile_type", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", _QUAD_WALKS)
def test_quadrant_walks_match_plain(cuda, kernel, tile_type, case, feat,
                                    aligned):
    """K1, K2, K9 and K8 (both orientations, from init and from zero) on
    256-wide tiles, walked as 128-wide quadrants, in the cases of
    ``test_nonzero_walks_match_plain``: against their plain versions; an
    empty quadrant, a zero tile, K9's pads and the zero tile row or
    diagonal block leave their rows at init or zero bit for bit, and a NaN
    entry reaches its own output row alone; the bf16 forms also bit for
    bit against the f32 walk on the tiles widened and x rounded."""
    rng = np.random.default_rng(feat + 60)
    ops, dense_blocks, nan_row, zero_block = _quad_operands(rng, kernel,
                                                            case)
    n = 1024
    x = torch.from_numpy(rng.standard_normal((n, feat)).astype(
        np.float32)).to(cuda)
    xd = x if aligned else _unaligned(x)
    walk, plain = _NONZERO_WALKS[kernel]
    base = torch.zeros_like(x)
    bf16 = tile_type == "bf16"
    if kernel in _DIAG_WALKS:
        transpose, with_init = _DIAG_WALKS[kernel]
        if with_init:
            base = torch.from_numpy(rng.standard_normal((n, feat)).astype(
                np.float32)).to(cuda)
        tiles = ops.to(cuda)
        tiles = tiles.to(torch.bfloat16) if bf16 else tiles

        def args(t, xx):
            return (t, xx, 2, transpose, base if with_init else None)

        wide = tiles.float()
    else:
        b = ops.to(cuda)
        assert b.block == _EDGE
        if kernel == "K1":
            base = torch.from_numpy(rng.standard_normal((n, feat)).astype(
                np.float32)).to(cuda)

        def args(t, xx):
            return (t, xx) + ((base,) if kernel == "K1" else ())

        tiles = dataclasses.replace(b, blocks=b.blocks.to(torch.bfloat16)) \
            if bf16 else b
        wide = dataclasses.replace(b, blocks=tiles.blocks.float())
    count = "launches_bf16" if bf16 else "launches"
    before = getattr(walk, count)
    with torch.inference_mode():
        got = walk(*args(tiles, xd))
        ref = plain(*args(tiles, xd))
        if bf16:
            f32_walk = walk(*args(wide, x.to(torch.bfloat16).float()))
    torch.cuda.synchronize()
    assert getattr(walk, count) == before + 1
    if bf16:
        assert _bf16_nan_equal(got, f32_walk)
    nan = ref.isnan()
    if nan_row is None:
        _close(got, ref)
    else:
        assert nan.any(1).nonzero().flatten().tolist() == [nan_row]
        assert torch.equal(got.isnan(), nan)
        keep = ~nan.any(1)
        _close(got[keep], ref[keep])
    if zero_block is not None:
        rows = slice(zero_block * _EDGE, (zero_block + 1) * _EDGE)
        assert torch.equal(got[rows], base[rows])
    # output rows 0-9 of each 128-row half take quadrant rows (columns for
    # K8 transposed) 0-9, empty in every tile
    empty = torch.cat([torch.arange(r * 128, r * 128 + 10)
                       for r in range(n // 128) if r not in dense_blocks])
    assert torch.equal(got[empty.to(cuda)], base[empty.to(cuda)])


@pytest.mark.parametrize("bf16", [False, True])
def test_walk_entries_refuse_an_edge_they_do_not_walk(cuda, bf16):
    """The C entries themselves refuse a tile edge they have no form for:
    K10 anything but 128 (the row walk builds no quadrant form), K2 an
    edge off the multiples of 128; cudaErrorInvalidValue (1), nothing
    launched.  At 128 both launch."""
    from fitgnn_tpu_torch.ops import bsr_spmm as bsr_mod, kernels
    rng = np.random.default_rng(31)
    s, r, w = _coo(rng, 512, 2000)
    b = build_bsr(s, r, w, 512, rowwalk=True,
                  tile_dtype=torch.bfloat16 if bf16 else None).to(cuda)
    x = torch.randn((512, 16), device=cuda)
    out = torch.zeros_like(x)
    # occupancy words (all quadrants live) where a case passes them: no
    # entry has a words form at 128, and K10 has none at all
    words = torch.full((b.nnz_blocks,), -1, dtype=torch.int64, device=cuda)
    for name, block, w, want in (("fitgnn_bsr_spmm_rowwalk", 256, None, 1),
                                 ("fitgnn_bsr_spmm_rowwalk", 128, None, 0),
                                 ("fitgnn_bsr_spmm", 192, None, 1),
                                 ("fitgnn_bsr_spmm", 128, None, 0),
                                 ("fitgnn_bsr_spmm", 128, words, 1),
                                 ("fitgnn_bsr_spmm_rowwalk", 128, words, 1)):
        fn = kernels.function("bsr_spmm", kernels.entry(name, b.blocks),
                              bsr_mod._ARGS_FWD)
        rc = fn(kernels.ptr(b.blocks), kernels.ptr(b.row_splits),
                kernels.ptr(b.cols), None if w is None else kernels.ptr(w),
                kernels.ptr(x), kernels.ptr(out), b.num_row_blocks, 16,
                block, kernels.stream(cuda))
        torch.cuda.synchronize()
        assert rc == want, (name, block, w is not None, rc)


# --- occupancy words: the walk of the live quadrants alone ----------------

_WORD_WALKS = ("K1", "K2", "K9")


def _words_case(rng, kernel, tile_type, feat, aligned, cuda):
    """The quadrant walks' sparse operands (``_quad_operands``) on the
    card in ``tile_type``, x (unaligned unless ``aligned``) and K1's
    init."""
    b, *_ = _quad_operands(rng, kernel, "sparse")
    if tile_type == "bf16":
        b = dataclasses.replace(b, blocks=b.blocks.to(torch.bfloat16))
    x = torch.from_numpy(rng.standard_normal((1024, feat)).astype(
        np.float32)).to(cuda)
    ins = (x if aligned else _unaligned(x),)
    if kernel == "K1":
        ins += (torch.from_numpy(rng.standard_normal((1024, feat)).astype(
            np.float32)).to(cuda),)
    return b.to(cuda), ins


@pytest.mark.parametrize("feat,aligned", [(40, False), (40, True),
                                          (512, True)])
@pytest.mark.parametrize("tile_type", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", _WORD_WALKS)
def test_quadwords_walks_match_plain(cuda, kernel, tile_type, feat, aligned):
    """K1, K2 and K9 at edge 256 with occupancy words (the live quadrants,
    each one's slab copy started with its tile read): against their plain
    versions with the words (at F=40 on an unaligned x, the 4-byte slab
    copy), and bit for bit the walk without words (null words), which
    reads and votes on every quadrant; each walk counts one launch."""
    rng = np.random.default_rng(feat + 210)
    b, ins = _words_case(rng, kernel, tile_type, feat, aligned, cuda)
    walk, plain = _NONZERO_WALKS[kernel]
    count = "launches_bf16" if tile_type == "bf16" else "launches"
    before = getattr(walk, count)
    with torch.inference_mode():
        got = walk(b, *ins)
        ref = plain(b, *ins)
        without = walk(dataclasses.replace(b, words=False), *ins)
    torch.cuda.synchronize()
    assert getattr(walk, count) == before + 2
    _close(got, ref)
    assert torch.equal(got, without)


@pytest.mark.parametrize("tile_type", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", _WORD_WALKS)
def test_quadwords_cleared_bit_is_honoured(cuda, kernel, tile_type):
    """A live quadrant whose bit is cleared is not applied, as the plain
    version with those words leaves it out: its 128-row output block
    changes, every other row stays bit for bit."""
    rng = np.random.default_rng(221)
    b, ins = _words_case(rng, kernel, tile_type, 128, True, cuda)
    walk, plain = _NONZERO_WALKS[kernel]
    lo = int(b.row_splits[1])                     # tile row 1's first tile
    assert int(b.quad_bits[lo]) >> 3 & 1          # quadrant (1, 1) is live
    cleared = dataclasses.replace(b)
    cleared.quad_bits = b.quad_bits.clone()
    cleared.quad_bits[lo] &= ~(1 << 3)
    with torch.inference_mode():
        full = walk(b, *ins)
        got = walk(cleared, *ins)
        ref = plain(cleared, *ins)
    torch.cuda.synchronize()
    _close(got, ref)
    block = slice(3 * 128, 4 * 128)               # tile row 1, half 1
    assert not torch.equal(got[block], full[block])
    rest = torch.ones(got.shape[0], dtype=torch.bool, device=cuda)
    rest[block] = False
    assert torch.equal(got[rest], full[rest])


@pytest.mark.parametrize("tile_type", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", _WORD_WALKS)
def test_quadwords_inf_only_an_empty_quadrant_reaches(cuda, kernel,
                                                      tile_type):
    """The walk's divergence from the dense product (``ROADMAP.md`` §3): an
    inf in x at a row that only empty quadrants reach (slab half 1 of tile
    column 1, whose quadrant column 1 is cleared in every tile) leaves the
    output finite, as the plain version with words does; the dense
    product, the plain version without words, gives NaN there."""
    rng = np.random.default_rng(231)
    b, ins = _words_case(rng, kernel, tile_type, 128, True, cuda)
    walk, plain = _NONZERO_WALKS[kernel]
    blocks = b.blocks.clone()
    blocks[b.cols == 1, :, 128:] = 0
    b = dataclasses.replace(b, blocks=blocks)
    x = ins[0].clone()
    x[3 * 128 + 50] = float("inf")                # slab 2·1 + 1, row 50
    ins = (x, *ins[1:])
    with torch.inference_mode():
        got = walk(b, *ins)
        ref = plain(b, *ins)
        dense = plain(dataclasses.replace(b, words=False), *ins)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ref).all()) and dense.isnan().any()
    _close(got, ref)


@pytest.mark.parametrize("use_diag", [False, True])
def test_block256_training_on_card_matches_cpu(cuda, use_diag):
    """One GCN training step (hidden 64, dropout off) on the 256-wide
    operator (with and without the diagonal split), kernels on the card
    against plain versions on the CPU: K3, K1 (where off-diagonal tiles
    stay) and K8 launched four times each."""
    rng = np.random.default_rng(13)
    n, feat = 1920, 128                  # 2,048 rows padded: 8 tiles of 256
    s, r = _bench_like(rng, n=n, e=20_000)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = rng.integers(0, 5, n)
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=rng.random(n) < .5,
                                 min_block_edges=48)
    h = build_hybrid(g.senders.numpy(), g.receivers.numpy(),
                     g.edge_weight.numpy(), g.num_nodes_padded,
                     min_block_edges=96, block=_EDGE, use_segmm=True,
                     use_diag=use_diag)
    assert (h.diag_blocks is not None) == use_diag
    assert h.bsr is not None or use_diag
    k1 = 0 if h.bsr is None else 4
    if h.bsr is not None:
        assert h.bsr.block == _EDGE
    g = g._replace(aux=h)
    model = NodeModel("GCNConv", feat, 64, 2, 5, dropout_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0)).train()
    loss_c, grads_c = _grads(model, g, g.y, g.train_mask)
    gd = g.to(cuda)
    before = (bsr_spmm_acc.launches, diag_spmm.launches,
              segmm_spmm.launches)
    loss_d, grads_d = _grads(model.to(cuda), gd, gd.y, gd.train_mask)
    torch.cuda.synchronize()
    assert (bsr_spmm_acc.launches, diag_spmm.launches,
            segmm_spmm.launches) == (before[0] + k1,
                                     before[1] + 4 * use_diag, before[2] + 4)
    _close(loss_d, loss_c)
    for k, v in grads_c.items():
        _close(grads_d[k], v)


# --- GAT's dynamic tiles at edge 256: K4, K4ᵀ and K5 ------------------------

def _dyn_quad_operands(rng, kernel, case):
    """K4's or K4ᵀ's operands on 256-wide tiles (1,024 nodes: four tile
    rows): a sorted tile list covering every tile row whose tile column 2
    is never used (the transpose plan's scale-0 filler slot), for K4 with
    tile row 2 holding only a zero coverage filler; ~3% values, rows and
    columns 0-9 of every 128-wide quadrant empty and quadrant (0, 1) of
    every tile empty; edited by ``case`` as ``_quad_operands`` edits its
    tiles.  Returns ``(rows, cols, plan, blocks)``, the 128-row output
    blocks of the dense tile, the output row the NaN must reach and the
    256-row output block that no non-zero reaches."""
    nb = 4
    rows = np.sort(np.concatenate([np.arange(nb), rng.integers(0, nb, 8)]))
    cols = rng.choice([0, 1, 3], len(rows))
    zero_block = 2
    if kernel == "K4":
        first = int(np.searchsorted(rows, zero_block))
        keep = (rows != zero_block) | (np.arange(len(rows)) == first)
        rows, cols = rows[keep], cols[keep]
    plan = build_dyn_plan(rows, cols, nb)
    assert plan.t_scale.numpy().tolist().count(0) == 1
    splits = (plan.row_splits if kernel == "K4" else plan.t_row_splits).numpy()
    run = int(np.argmax(np.diff(splits)))
    lo, hi = int(splits[run]), int(splits[run + 1])
    assert hi - lo >= 2
    blocks = np.where(rng.random((len(rows), _EDGE, _EDGE)) < 0.03,
                      rng.standard_normal((len(rows), _EDGE, _EDGE)), 0.0)
    for q in (0, 128):
        blocks[:, q:q + 10, :] = 0.0
        blocks[:, :, q:q + 10] = 0.0
    blocks[:, :128, 128:] = 0.0
    if kernel == "K4":
        blocks[first] = 0.0
        tile = lo + 1
    else:
        tile = int(plan.t_sel[lo])
    rows_walk = kernel == "K4"
    dense_blocks, nan_row = [], None
    if case == "dense":
        blocks[tile] = rng.random((_EDGE, _EDGE)) + 0.5
        c = rows[tile] if rows_walk else cols[tile]
        dense_blocks = [2 * c, 2 * c + 1]
    elif case == "zero_inside":
        blocks[tile] = 0.0
    elif case == "nan":
        # K4ᵀ: not tile 0, which the filler slot reads at scale 0 (the
        # plain version's 0·NaN would reach the filler's block)
        tile = len(rows) - 1 if kernel == "K4T" else tile
        blocks[tile, 150, 200] = np.nan
        nan_row = (rows[tile] * _EDGE + 150 if rows_walk
                   else cols[tile] * _EDGE + 200)
    ops = (torch.from_numpy(rows.astype(np.int32)),
           torch.from_numpy(cols.astype(np.int32)), plan,
           torch.from_numpy(blocks.astype(np.float32)))
    return ops, dense_blocks, nan_row, zero_block


@pytest.mark.parametrize("feat,aligned", [(40, True), (128, True),
                                          (512, True), (40, False)])
@pytest.mark.parametrize("case", ["sparse", "dense", "zero_inside", "nan"])
@pytest.mark.parametrize("kernel", ["K4", "K4T"])
def test_dyn_quadrant_walks_match_plain(cuda, kernel, case, feat, aligned):
    """K4 and K4ᵀ (the transpose plan, with its filler slot) on 256-wide
    tiles, walked as 128-wide quadrants, in the cases of
    ``test_nonzero_walks_match_plain``: against their plain versions; an
    empty quadrant, a zero tile, K4's zero coverage filler and K4ᵀ's
    scale-0 slot leave their rows at zero bit for bit, and a NaN entry
    reaches its own output row alone."""
    rng = np.random.default_rng(feat + 70)
    ops, dense_blocks, nan_row, zero_block = _dyn_quad_operands(rng, kernel,
                                                                case)
    n = 1024
    x = torch.from_numpy(rng.standard_normal((n, feat)).astype(
        np.float32)).to(cuda)
    xd = x if aligned else _unaligned(x)
    rows, cols, plan, blocks = ops
    args = (rows.to(cuda), cols.to(cuda), plan.to(cuda), blocks.to(cuda), xd)
    if kernel == "K4T":
        args = args[2:]
    walk, plain = _NONZERO_WALKS[kernel]
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
        assert torch.equal(got.isnan(), nan)
        keep = ~nan.any(1)
        _close(got[keep], ref[keep])
    zero = slice(zero_block * _EDGE, (zero_block + 1) * _EDGE)
    assert not got[zero].any()
    # output rows 0-9 of each 128-row half take quadrant rows (K4) or
    # columns (K4ᵀ) 0-9, empty in every tile
    empty = torch.cat([torch.arange(r * 128, r * 128 + 10)
                       for r in range(n // 128) if r not in dense_blocks])
    assert not got[empty.to(cuda)].any()


# F=101 and the unaligned g take K5's 4-byte loads; F=0 writes zeros
@pytest.mark.parametrize("feat,aligned", [(0, True), (40, True), (101, True),
                                          (128, True), (512, True),
                                          (64, False)])
def test_k5_quadrants_keep_f32_accuracy(cuda, feat, aligned):
    """K5 on 256-wide tiles (each 128 x 128 quadrant a CTA of its own on
    the tensor cores): the dense product of every tile, a coverage filler
    (tile row 2, column 0) included, within the tolerance of its plain f32
    version, and within 1e-5·max|ref| of each tile's float64 product; the
    g rows 384-511 (the lower half of tile row 1) are scaled by 1e3, so
    the quadrants of one tile hold both magnitudes."""
    rng = np.random.default_rng(feat + 80)
    nb = 4
    rows = np.sort(np.concatenate([np.arange(nb), rng.integers(0, nb, 8)]))
    cols = rng.choice([0, 1, 3], len(rows))
    first = int(np.searchsorted(rows, 2))
    rows, cols = np.insert(rows, first, 2), np.insert(cols, first, 0)
    g = rng.standard_normal((nb * _EDGE, feat)).astype(np.float32)
    g[384:512] *= 1e3
    x = rng.standard_normal((nb * _EDGE, feat)).astype(np.float32)
    rt = torch.from_numpy(rows.astype(np.int32)).to(cuda)
    ct = torch.from_numpy(cols.astype(np.int32)).to(cuda)
    gd, xd = torch.from_numpy(g).to(cuda), torch.from_numpy(x).to(cuda)
    gd = gd if aligned else _unaligned(gd)
    before = dyn_grad_blocks.launches
    with torch.inference_mode():
        got = dyn_grad_blocks(rt, ct, gd, xd, _EDGE)
        ref = dyn_grad_blocks_plain(rt, ct, gd, xd, _EDGE)
    torch.cuda.synchronize()
    assert dyn_grad_blocks.launches == before + 1
    assert got.shape == (len(rows), _EDGE, _EDGE)
    if feat == 0:
        assert not got.any()
        return
    _close(got, ref)
    ref64 = dyn_grad_blocks_plain(rt, ct, gd.double(), xd.double(), _EDGE)
    err = (got.double() - ref64).abs().flatten(1).max(1).values
    assert (err <= 1e-5 * ref64.abs().flatten(1).max(1).values).all()


@pytest.mark.parametrize("global_max", [True, False], ids=["bound", "exact"])
def test_gat_block256_training_on_card_matches_cpu(cuda, monkeypatch,
                                                   global_max):
    """One GAT training step (hidden 64, dropout off) on the 256-wide
    ``att_unit`` operator under ``GLOBAL_MAX`` 1 and 0, kernels on the card
    against plain versions on the CPU: K4, K4ᵀ and K5 twice each (at
    hidden 64 < 128 features layer 0 transforms before it aggregates, so
    its aggregation needs ``dx`` too); then the same step under
    ``FUSED_TILES=1`` (which raised until K7's forms at another edge were
    ported), on the card against the CPU: K7f, K7bt's ``dx``, K7s and
    K7sums twice each at 256, and K7rm twice under the exact max."""
    monkeypatch.setenv("FITGNN_GAT_GLOBAL_MAX", "1" if global_max else "0")
    rng = np.random.default_rng(14)
    n, feat = 1920, 128                  # 2,048 rows padded: 8 tiles of 256
    s, r = _bench_like(rng, n=n, e=20_000)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = rng.integers(0, 5, n)
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=rng.random(n) < .5,
                                 min_block_edges=48, layer_name="GATConv")
    h = build_hybrid(g.senders.numpy(), g.receivers.numpy(),
                     g.edge_weight.numpy(), g.num_nodes_padded,
                     min_block_edges=96, block=_EDGE, use_segmm=True,
                     semantics="att_unit")
    assert h.bsr.block == _EDGE and h.dyn_plan is not None
    g = g._replace(aux=h)
    model = NodeModel("GATConv", feat, 64, 2, 5, dropout_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0)).train()
    loss_c, grads_c = _grads(model, g, g.y, g.train_mask)
    gd = g.to(cuda)
    model = model.to(cuda)
    counts = (dyn_tiles, dyn_tiles_t, dyn_grad_blocks)
    before = tuple(c.launches for c in counts)
    loss_d, grads_d = _grads(model, gd, gd.y, gd.train_mask)
    torch.cuda.synchronize()
    assert tuple(c.launches - b for c, b in zip(counts, before)) == (2, 2, 2)
    _close(loss_d, loss_c)
    for k, v in grads_c.items():
        _close(grads_d[k], v)
    monkeypatch.setenv("FITGNN_GAT_FUSED_TILES", "1")
    model = model.cpu()
    loss_c, grads_c = _grads(model, g, g.y, g.train_mask)
    model = model.to(cuda)
    counts = (att_bsr.att_rowmax, att_bsr.att_fwd, att_bsr.att_bwd_t,
              att_bsr.att_bwd_scores, att_bsr.att_sums)
    before = tuple(c.launches for c in counts)
    loss_d, grads_d = _grads(model, gd, gd.y, gd.train_mask)
    torch.cuda.synchronize()
    assert tuple(c.launches - b for c, b in zip(counts, before)) == (
        0 if global_max else 2, 2, 2, 2, 2)
    _close(loss_d, loss_c)
    for k, v in grads_c.items():
        _close(grads_d[k], v)


# --- GAT's fused tile attention at edge 256: K7rm, K7f, K7bt, K7s, K7sums ---

def _k7_quad_operands(rng, kernel, case, feat):
    """K7's operands on 256-wide presence tiles (1,024 nodes: four tile
    rows), on the CPU, edited by ``case`` as ``_k7_walk_operands`` edits
    its 128-wide tiles: a sorted tile list covering every tile row whose
    tile column 2 is never used (the transpose plan's scale-0 filler
    slot), ~3% fill, quadrant (0, 1) of every tile empty and nodes 0-9
    without an entry (m = −1e30); the inf's row and the NaN's entry lie in
    the second 128-wide half (quadrant (1, 1) for the NaN).  ``x`` is the
    walk's slab operand (K7f's features, K7bt's cotangent g).  Returns the
    plan, the operands and the row of the inf or the output row of the
    NaN."""
    nb = 4
    rows = np.sort(np.concatenate([np.arange(nb), rng.integers(0, nb, 8)]))
    cols = rng.choice([0, 1, 3], len(rows))
    plan = build_dyn_plan(rows, cols, nb)
    assert plan.t_scale.numpy().tolist().count(0) == 1
    blocks = (rng.random((len(rows), _EDGE, _EDGE)) < 0.03).astype(
        np.float32)
    blocks[:, :128, 128:] = 0.0
    blocks[rows == 0, :10, :] = 0.0
    n = nb * _EDGE
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
        blocks[rows == 2] = 0.0
    elif case == "inf_unreached" and kernel == "K7f":
        blocks[cols == cols[tile], :, 178] = 0.0
        row = cols[tile] * _EDGE + 178
    elif case == "inf_unreached":
        blocks[rows == rows[tile], 178, :] = 0.0
        row = rows[tile] * _EDGE + 178
    elif case == "nan":
        if kernel == "K7f":                 # the one entry of its column
            blocks[cols == cols[tile], :, 158] = 0.0
        blocks[tile, 148, 158] = 1.0
        row = (rows[tile] * _EDGE + 148 if kernel == "K7f"
               else cols[tile] * _EDGE + 158)
    ops = {k: torch.from_numpy(v) for k, v in dict(
        rows=rows.astype(np.int32), cols=cols.astype(np.int32),
        blocks=blocks,
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
        ops["ssrc"][cols[tile] * _EDGE + 158] = float("nan")
    return plan, ops, row


@pytest.mark.parametrize("feat", [40, 128, 512])
@pytest.mark.parametrize("case", ["sparse", "dense", "zero_inside",
                                  "edgeless", "inf_unreached", "nan"])
@pytest.mark.parametrize("tile_type", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["K7f", "K7bt"])
def test_k7_quadrant_walks_match_plain(cuda, kernel, tile_type, case, feat):
    """K7f (``num`` and ``den``) and K7bt's ``dx`` on 256-wide masks,
    walked as 128-wide quadrants with ``pe`` worked out per non-zero from
    the quadrant's 128-row score slices, in the cases of
    ``test_k7_walks_match_plain``: against their plain versions; an inf
    that only masked-out entries reach leaves the output finite (held
    against the plain version with that row zeroed), a NaN in ``ssrc``
    reaches its own output row alone, and every output row that no entry
    reaches (the filler's tile column 2 among them) is written as 0; the
    bf16 form bit for bit against the f32 form on the same mask."""
    rng = np.random.default_rng(feat + 90)
    plan, ops, row = _k7_quad_operands(rng, kernel, case, feat)
    plan = plan.to(cuda)
    d = {k: v.to(cuda) for k, v in ops.items()}
    bf16 = tile_type == "bf16"
    tiles = d["blocks"].to(torch.bfloat16) if bf16 else d["blocks"]
    if kernel == "K7f":
        def run(fn, x, t):
            num, den = fn(d["rows"], d["cols"], plan, t, d["ssrc"],
                          d["sdst"], d["m"], x, 0.2)
            return torch.cat([num, den[:, None]], 1)

        walk, plain = att_bsr.att_fwd, att_bsr.att_fwd_plain
    else:
        def run(fn, g, t):
            return fn(plan, t, d["ssrc"], d["sdst"], d["m"], g,
                      d["x_other"], d["dden"], 0.2, need_dssrc=False)[0]

        walk, plain = att_bsr.att_bwd_t, att_bsr.att_bwd_t_plain
    before = (walk.launches, walk.launches_bf16)
    with torch.inference_mode():
        got = run(walk, d["x"], tiles)
        ref = run(plain, d["x"], tiles)
        f32 = run(walk, d["x"], d["blocks"]) if bf16 else got
        if case == "inf_unreached":
            clean = d["x"].clone()
            clean[row] = 0.0
            ref_clean = run(plain, clean, tiles)
    torch.cuda.synchronize()
    assert (walk.launches, walk.launches_bf16) == (before[0] + 1,
                                                   before[1] + bf16)
    assert _bf16_nan_equal(got, f32)
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
    reached = torch.zeros(got.shape[0], dtype=torch.bool)
    for k in range(len(ops["rows"])):
        hit = ops["blocks"][k].any(1 if kernel == "K7f" else 0)
        blk = int((ops["rows"] if kernel == "K7f" else ops["cols"])[k])
        reached[blk * _EDGE:(blk + 1) * _EDGE] |= hit
    if kernel == "K7bt":
        assert not reached[2 * _EDGE:3 * _EDGE].any()
    assert not got[~reached.to(cuda)].any()


@pytest.mark.parametrize("case", ["sparse", "dense", "zero_inside",
                                  "edgeless"])
@pytest.mark.parametrize("tile_type", ["f32", "bf16"])
def test_k7_rowmax_quadrants_match_plain(cuda, tile_type, case):
    """K7rm on 256-wide masks (a CTA per 128-row half of a tile row, over
    its quadrants): bit for bit against the plain version, −1e30 on the
    nodes without an entry (0-9, and tile row 2 when edgeless)."""
    rng = np.random.default_rng(91)
    plan, ops, _ = _k7_quad_operands(rng, "K7f", case, 8)
    d = {k: v.to(cuda) for k, v in ops.items()}
    tiles = d["blocks"].to(torch.bfloat16) if tile_type == "bf16" \
        else d["blocks"]
    fn = att_bsr.att_rowmax
    before = (fn.launches, fn.launches_bf16)
    with torch.inference_mode():
        got = fn(d["rows"], d["cols"], plan.to(cuda), tiles, d["ssrc"],
                 d["sdst"], 0.2)
    torch.cuda.synchronize()
    bf16 = tile_type == "bf16"
    assert (fn.launches, fn.launches_bf16) == (before[0] + (not bf16),
                                               before[1] + bf16)
    assert torch.equal(got.cpu(), ops["m"])
    assert (got[:10] == -1e30).all()
    if case == "edgeless":
        assert (got[2 * _EDGE:3 * _EDGE] == -1e30).all()


# forward tiles of the score pass's card test at 256 (1,280 nodes, five
# tile rows): tile row 1 has 4 tiles, tile column 2 none (a transpose
# filler), tile row 3 none (dsdst written as 0)
_SCORE_QUAD_ROWS = [0, 0, 1, 1, 1, 1, 2, 4, 4]
_SCORE_QUAD_COLS = [0, 1, 0, 1, 3, 4, 3, 0, 4]


def _score_quad_operands(rng, feat, dev, full):
    """``_score_operands`` on 256-wide tiles: 3% fill with positive values
    at the mask, quadrant (0, 1) of every tile empty but tile 2 (tile row
    1 against column 0), which is full when ``full``; nodes 0-9 have no
    entry (m = −1e30)."""
    nb = 5
    rows = np.asarray(_SCORE_QUAD_ROWS, np.int32)
    cols = np.asarray(_SCORE_QUAD_COLS, np.int32)
    mask = rng.random((len(rows), _EDGE, _EDGE)) < 0.03
    mask[:, :128, 128:] = False
    if full:
        mask[2] = True
    mask[0, :10] = mask[1, :10] = False
    blocks = np.where(mask, rng.random(mask.shape) + 0.5, 0.0)
    n = nb * _EDGE

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


@pytest.mark.parametrize("feat", [40, 128, 512])
@pytest.mark.parametrize("case", ["sparse", "full", "inf_unreached",
                                  "inf_reached", "deterministic"])
@pytest.mark.parametrize("tile_type", ["f32", "bf16"])
def test_k7_score_pass_quadrants_match_plain(cuda, tile_type, case, feat):
    """K7's score pass on 256-wide masks (one CTA a 128-wide quadrant, the
    partials (K, 2·256)) and its partials' sums, in the cases of
    ``test_k7_score_pass_matches_plain``: the partials and both score
    gradients against their plain versions, two launches bit-equal, the
    bf16 form bit for bit against the f32 form on the same mask;
    ``inf_reached`` gives NaN exactly where the plain version is not
    finite (the 3xTF32 split's recorded divergence)."""
    rng = np.random.default_rng(feat + 95)
    plan, d = _score_quad_operands(rng, feat, cuda, full=case == "full")
    if case == "inf_unreached":
        d["g"][3, 0] = float("inf")                # node 3 has no entry
        d["blocks"][d["cols"] == 3, :, 5] = 0.0    # column 3·256+5 unreached
        d["x"][3 * _EDGE + 5, feat // 2] = float("-inf")
    if case == "inf_reached":
        i = 2 * _EDGE + int(torch.nonzero(d["blocks"][6].sum(1))[0])
        d["g"][i, feat - 1] = float("inf")
    bf16 = tile_type == "bf16"
    tiles = d["blocks"].to(torch.bfloat16) if bf16 else d["blocks"]

    def args(t):
        return (d["rows"], d["cols"], plan, t, d["ssrc"], d["sdst"], d["m"],
                d["g"], d["x"], d["dden"], 0.2)

    fn = att_bsr.att_bwd_scores
    before = (fn.launches, fn.launches_bf16, att_bsr.att_sums.launches)
    with torch.inference_mode():
        got = fn(*args(tiles))
        again = fn(*args(tiles))
        ref = att_bsr.att_bwd_scores_plain(*args(tiles))
        f32 = fn(*args(d["blocks"])) if bf16 else got
        part = att_bsr._launch_scores("k7s", cuda, tiles, d["rows"],
                                      d["cols"], None, d["ssrc"], d["sdst"],
                                      d["m"], d["g"], d["x"], d["dden"], 0.2)
        part_p = att_bsr.att_scores_plain(*args(tiles))
        sums = att_bsr.att_sums(plan, *part_p)
        sums_p = att_bsr.att_sums_plain(plan, *part_p)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_bf16, att_bsr.att_sums.launches) == (
        before[0] + 2 * (not bf16) + bf16, before[1] + 2 * bf16,
        before[2] + 3 + bf16)
    assert part[0].shape == (len(_SCORE_QUAD_ROWS), 2 * _EDGE)
    for a, b in zip(got, again):
        assert _bf16_nan_equal(a, b)
    for a, b in zip(got, f32):
        assert _bf16_nan_equal(a, b)
    if case == "inf_reached":
        for a, b in zip(got, ref):
            bad = ~torch.isfinite(b)
            assert bad.any() and torch.equal(a.isnan(), bad)
            _close(a[~bad], b[~bad])
        return
    for a, b in (*zip(got, ref), *zip(part, part_p), *zip(sums, sums_p)):
        _close(a, b)
    dssrc, dsdst = got
    assert not dsdst[:10].any() and not dsdst[3 * _EDGE:4 * _EDGE].any()
    assert not dssrc[2 * _EDGE:3 * _EDGE].any()      # no tile in column 2


@pytest.mark.parametrize("wrapper", ["att_rowmax", "att_fwd", "att_bwd_t",
                                     "att_bwd_scores", "att_sums"])
def test_k7_wrappers_refuse_an_edge_off_128_on_card(cuda, wrapper):
    """On CUDA tensors, tiles of edge 192 (and partials of a 192-wide tile)
    raise ``ValueError`` before any launch, as on the CPU; the C entries
    themselves return cudaErrorInvalidValue (1) for block 192."""
    from fitgnn_tpu_torch.ops import kernels
    rows = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    cols = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    plan = build_dyn_plan(rows.cpu().numpy(), cols.cpu().numpy(), 2).to(cuda)
    blocks = torch.ones((2, 192, 192), device=cuda)
    v = torch.zeros(384, device=cuda)
    x = torch.ones((384, 8), device=cuda)
    bwd = (plan, blocks, v, v, v, x, x, v, 0.2)
    calls = {
        "att_rowmax": lambda: att_bsr.att_rowmax(rows, cols, plan, blocks, v,
                                                 v, 0.2),
        "att_fwd": lambda: att_bsr.att_fwd(rows, cols, plan, blocks, v, v,
                                           v, x, 0.2),
        "att_bwd_t": lambda: att_bsr.att_bwd_t(*bwd),
        "att_bwd_scores": lambda: att_bsr.att_bwd_scores(rows, cols, *bwd),
        "att_sums": lambda: att_bsr.att_sums(
            plan, torch.zeros((2, 192), device=cuda),
            torch.zeros((2, 192), device=cuda))}
    counted = (att_bsr.att_rowmax, att_bsr.att_fwd, att_bsr.att_bwd_t,
               att_bsr.att_bwd_scores)
    before = [f.launches for f in counted] + [att_bsr.att_sums.launches]
    with pytest.raises(ValueError, match="multiple of 128"):
        calls[wrapper]()
    assert [f.launches for f in counted] + [att_bsr.att_sums.launches] \
        == before
    if wrapper == "att_rowmax":
        out = torch.empty_like(v)
        fn = kernels.function("att_bsr", "fitgnn_att_rowmax",
                              att_bsr._ROWMAX_ARGTYPES)
        rc = fn(kernels.ptr(blocks), kernels.ptr(plan.row_splits),
                kernels.ptr(cols), kernels.ptr(v), kernels.ptr(v),
                kernels.ptr(out), 2, 192, 0.2, kernels.stream(cuda))
        torch.cuda.synchronize()
        assert rc == 1


# --- occupancy words in K7's fused path: K7f's live walk, K7s's live grid --

def _k7words_operands(rng, edge, tile_type, feat, case="sparse"):
    """K7's operands on ``edge``-wide 0/1 masks (four tile rows): a sorted
    tile list covering every tile row whose tile column 2 is never used
    (the transpose plan's filler slot), ~3% fill with each 128-wide
    quadrant empty at odds 0.4 and quadrant (0, 1) of every tile empty;
    under ``one_live`` tile 1 keeps quadrant (1, 0) alone, and under
    ``inf_empty`` the second 128-wide half of tile column ``cols[1]`` and
    of tile row ``rows[1]`` is empty in every tile, with an inf in x at a
    row of that column half and in g at a row of that row half (slabs
    that only empty quadrants reach).  The plan carries the mask's words
    and ``live``; ``m`` is the exact max.  Returns the plan and the
    operands on the CPU."""
    nb, nq = 4, edge // 128
    rows = np.sort(np.concatenate([np.arange(nb), rng.integers(0, nb, 8)]))
    cols = rng.choice([0, 1, 3], len(rows))
    k = len(rows)
    empty = rng.random((k, nq, nq)) < 0.4
    empty[:, 0, 1] = True
    if case == "one_live":
        empty[1] = True
        empty[1, 1, 0] = False
    mask = (rng.random((k, edge, edge)) < 0.03) & ~np.repeat(np.repeat(
        empty, 128, 1), 128, 2)
    if case == "one_live":
        mask[1, 128:256, :128] |= rng.random((128, 128)) < 0.03
    if case == "inf_empty":
        mask[cols == cols[1], :, 128:256] = False
        mask[rows == rows[1], 128:256, :] = False
    blocks = torch.from_numpy(mask.astype(np.float32))
    if tile_type == "bf16":
        blocks = blocks.to(torch.bfloat16)
    plan = build_dyn_plan(rows, cols, nb, words=quad_words(blocks, edge),
                          block=edge)
    n = nb * edge
    d = {key: torch.from_numpy(v) for key, v in dict(
        rows=rows.astype(np.int32), cols=cols.astype(np.int32),
        ssrc=rng.standard_normal(n).astype(np.float32),
        sdst=rng.standard_normal(n).astype(np.float32),
        x=rng.standard_normal((n, feat)).astype(np.float32),
        g=rng.standard_normal((n, feat)).astype(np.float32),
        dden=rng.standard_normal(n).astype(np.float32)).items()}
    d["blocks"] = blocks
    d["m"] = att_bsr.att_rowmax_plain(d["rows"], d["cols"], plan, blocks,
                                      d["ssrc"], d["sdst"], 0.2)
    if case == "one_live":
        assert int(plan.words[1]) == 1 << nq
    if case == "inf_empty":
        d["x"][int(cols[1]) * edge + 200, feat // 2] = float("inf")
        d["g"][int(rows[1]) * edge + 150, 0] = float("-inf")
    return plan, d


def _k7words_runs(kernel, d, plan):
    """K7f (``num``, ``den``), K7bt's ``dx`` or K7s + K7sums (``dssrc``,
    ``dsdst``, then the pass's partials) on a plan: (the kernels, the plain
    version)."""
    if kernel == "K7bt":
        args = [plan] + [d[k] for k in ("blocks", "ssrc", "sdst", "m", "g",
                                        "x", "dden")] + [0.2]
        return (lambda: att_bsr.att_bwd_t(*args, need_dssrc=False)[:1],
                lambda: att_bsr.att_bwd_t_plain(*args, need_dssrc=False)[:1])
    if kernel == "K7f":
        args = [d[k] for k in ("rows", "cols")] + [plan] + [
            d[k] for k in ("blocks", "ssrc", "sdst", "m", "x")] + [0.2]
        return (lambda: att_bsr.att_fwd(*args),
                lambda: att_bsr.att_fwd_plain(*args))
    args = [d[k] for k in ("rows", "cols")] + [plan] + [
        d[k] for k in ("blocks", "ssrc", "sdst", "m", "g", "x", "dden")] \
        + [0.2]

    def kernels_():
        part = att_bsr._launch_scores(
            "k7s", d["x"].device, d["blocks"], d["rows"], d["cols"],
            plan.live, *(d[k] for k in ("ssrc", "sdst", "m", "g", "x",
                                        "dden")), 0.2)
        return (*att_bsr.att_bwd_scores(*args), *part)

    def plain():
        return (*att_bsr.att_bwd_scores_plain(*args),
                *att_bsr.att_scores_plain(*args))
    return kernels_, plain


def _k7words_without(plan):
    return dataclasses.replace(plan, words=None, t_words=None, live=None)


_K7WORDS_COUNTERS = {"K7f": att_bsr.att_fwd, "K7bt": att_bsr.att_bwd_t,
                     "K7s": att_bsr.att_bwd_scores}


@pytest.mark.parametrize("feat,aligned", [(40, True), (40, False),
                                          (128, True), (512, True)])
@pytest.mark.parametrize("tile_type", ["f32", "bf16"])
@pytest.mark.parametrize("edge", [256, 512])
@pytest.mark.parametrize("kernel", ["K7f", "K7s", "K7bt"])
def test_k7words_match_plain(cuda, kernel, edge, tile_type, feat, aligned):
    """K7f with the plan's occupancy words (the rows walk of the live
    quadrants under its score hook: each quadrant's ssrc staged with its
    slab, two buffers, den's partials in shared memory), K7bt's ``dx``
    with the transpose slots' words (the columns walk of the live
    quadrants under its score hook: the partner's sdst and m staged with
    each slab, two buffers; the filler slot's word 0) and K7s on the
    plan's live list (one CTA a live quadrant, the partials from zeros),
    at edges 256 and 512, f32 and bf16 masks: against their plain versions
    (at F=40 on unaligned x and g, the 4-byte copies), and bit for bit the
    launches without words and ``live``; each counts its launches."""
    rng = np.random.default_rng(edge + feat + aligned + 230)
    plan, d = _k7words_operands(rng, edge, tile_type, feat)
    d = {k: v.to(cuda) for k, v in d.items()}
    if not aligned:
        d["x"], d["g"] = _unaligned(d["x"]), _unaligned(d["g"])
    plan = plan.to(cuda)
    assert plan.live.numel() < d["rows"].numel() * (edge // 128) ** 2
    run, plain = _k7words_runs(kernel, d, plan)
    without, _ = _k7words_runs(kernel, d, _k7words_without(plan))
    fn = _K7WORDS_COUNTERS[kernel]
    before = fn.launches + fn.launches_bf16
    with torch.inference_mode():
        got, ref, base = run(), plain(), without()
    torch.cuda.synchronize()
    assert fn.launches + fn.launches_bf16 == before + 2
    for a, b, c in zip(got, ref, base):
        _close(a, b)
        assert torch.equal(a, c)


@pytest.mark.parametrize("tile_type", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["one_live", "inf_empty"])
@pytest.mark.parametrize("kernel", ["K7f", "K7s", "K7bt"])
def test_k7words_bit_equal_without_words(cuda, kernel, case, tile_type):
    """K7f, K7bt's ``dx`` and K7s with words and ``live`` give the
    launches without them bit for bit on a tile whose quadrants are all
    empty but one, and with an inf in x and g that only empty quadrants
    reach: finite, since no form applies an empty quadrant's product (the
    walks skip it or the select drops it; the grid runs no CTA there)."""
    rng = np.random.default_rng(251 + len(case))
    plan, d = _k7words_operands(rng, 256, tile_type, 128, case)
    d = {k: v.to(cuda) for k, v in d.items()}
    plan = plan.to(cuda)
    run, plain = _k7words_runs(kernel, d, plan)
    without, _ = _k7words_runs(kernel, d, _k7words_without(plan))
    with torch.inference_mode():
        got, base = run(), without()
        ref = plain() if case == "one_live" else None
    torch.cuda.synchronize()
    for a, c in zip(got, base):
        assert torch.isfinite(a).all() and torch.equal(a, c)
    if ref is not None:
        for a, b in zip(got, ref):
            _close(a, b)


def test_k7words_refused_where_there_is_no_form(cuda):
    """Words on 128-wide masks (which ``build_dyn_plan`` never makes), to
    the forward walk or to the dx walk, raise, and so does a live list at
    128: there is no fallback to the launch without them."""
    rows = torch.tensor([0, 1], dtype=torch.int32)
    cols = torch.tensor([1, 0], dtype=torch.int32)
    plan = build_dyn_plan(rows.numpy(), cols.numpy(), 2)
    plan.words = torch.full((2,), 1, dtype=torch.int64)
    plan.live = torch.tensor([0, 1], dtype=torch.int32)
    plan = plan.to(cuda)
    rows, cols = rows.to(cuda), cols.to(cuda)
    blocks = torch.ones((2, 128, 128), device=cuda)
    v = torch.zeros(256, device=cuda)
    x = torch.ones((256, 8), device=cuda)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        att_bsr.att_fwd(rows, cols, plan, blocks, v, v, v, x, 0.2)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        att_bsr.att_bwd_scores(rows, cols, plan, blocks, v, v, v, x, x, v,
                               0.2)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        att_bsr._launch_walk("dx", blocks.device, blocks,
                             plan.t_row_splits, plan.t_sel, plan.t_scale,
                             plan.t_cols, plan.words, v, v, v, x, None, True,
                             0.2)


# --- K7sums: the partials of the live quadrants alone ----------------------

def _k7sums_partials(d, plan):
    """K7s's partials on the plan's live list (zeros where no CTA runs)."""
    return att_bsr._launch_scores(
        "k7s", d["x"].device, d["blocks"], d["rows"], d["cols"], plan.live,
        *(d[k] for k in ("ssrc", "sdst", "m", "g", "x", "dden")), 0.2)


@pytest.mark.parametrize("feat", [128, 512])
@pytest.mark.parametrize("tile_type", ["f32", "bf16"])
@pytest.mark.parametrize("edge", [256, 512])
def test_k7sums_words_match_plain(cuda, edge, tile_type, feat):
    """K7sums with the plan's words and t_words on K7s's partials with
    ``live`` (f32 and bf16 masks): within tolerance of ``att_sums_plain``,
    bit for bit the launch without words and two launches bit-equal; one
    launch counted a call."""
    rng = np.random.default_rng(edge + feat + len(tile_type) + 260)
    plan, d = _k7words_operands(rng, edge, tile_type, feat)
    d = {k: v.to(cuda) for k, v in d.items()}
    plan = plan.to(cuda)
    before = att_bsr.att_sums.launches
    with torch.inference_mode():
        part = _k7sums_partials(d, plan)
        got = att_bsr.att_sums(plan, *part)
        again = att_bsr.att_sums(plan, *part)
        without = att_bsr.att_sums(_k7words_without(plan), *part)
        ref = att_bsr.att_sums_plain(plan, *part)
    torch.cuda.synchronize()
    assert att_bsr.att_sums.launches == before + 3
    for a, b, c, r in zip(got, again, without, ref):
        _close(a, r)
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("tile_type", ["f32", "bf16"])
def test_k7sums_nan_only_in_an_empty_quadrant_stays_out(cuda, tile_type):
    """The contract of the words: a NaN planted in the partials of a
    quadrant whose bit is clear (tile 1's quadrant (0, 1), empty in every
    tile: row partial ``rpart[1][1][5]`` and column partial
    ``cpart[1][0][128 + 7]``) is never read by the words launch, which
    gives the clean partials' sums bit for bit; the launch without words
    and the plain version read it, in the rows it reaches alone."""
    rng = np.random.default_rng(257)
    plan, d = _k7words_operands(rng, 256, tile_type, 128)
    d = {k: v.to(cuda) for k, v in d.items()}
    plan = plan.to(cuda)
    assert not (int(plan.words[1]) >> 1) & 1
    slot = int(torch.nonzero(plan.t_sel == 1)[0])
    assert not (int(plan.t_words[slot]) >> 2) & 1    # (0, 1) transposed
    with torch.inference_mode():
        cpart, rpart = _k7sums_partials(d, plan)
        clean = att_bsr.att_sums(plan, cpart, rpart)
        cpart[1, 128 + 7] = rpart[1, 256 + 5] = float("nan")
        got = att_bsr.att_sums(plan, cpart, rpart)
        without = att_bsr.att_sums(_k7words_without(plan), cpart, rpart)
        ref = att_bsr.att_sums_plain(plan, cpart, rpart)
    torch.cuda.synchronize()
    for a, c in zip(got, clean):
        assert torch.isfinite(a).all() and torch.equal(a, c)
    reached = (int(d["cols"][1]) * 256 + 128 + 7,
               int(d["rows"][1]) * 256 + 5)
    for out in (without, ref):
        for v, row in zip(out, reached):
            assert torch.nonzero(v.isnan()).flatten().tolist() == [row]


def test_k7sums_edge128_matches_plain(cuda):
    """At edge 128 (no words) the same kernel: against the plain version on
    the score pass's partials and two launches bit-equal."""
    rng = np.random.default_rng(128)
    plan, d = _score_operands(rng, 128, cuda, full=False)
    with torch.inference_mode():
        part = _k7sums_partials(d, plan)
        got, again = (att_bsr.att_sums(plan, *part) for _ in range(2))
        ref = att_bsr.att_sums_plain(plan, *part)
    torch.cuda.synchronize()
    for a, b, r in zip(got, again, ref):
        _close(a, r)
        assert torch.equal(a, b)


def test_k7sums_refuses_bad_words_and_alignment(cuda):
    """Words of another dtype or length, words for one walk only and
    partials off 16 bytes raise before a launch."""
    rng = np.random.default_rng(5)
    plan, d = _k7words_operands(rng, 256, "f32", 16)
    plan = plan.to(cuda)
    d = {k: v.to(cuda) for k, v in d.items()}
    cpart, rpart = _k7sums_partials(d, plan)
    before = att_bsr.att_sums.launches
    for bad, match in (
            (dict(words=plan.words.int()), "words"),
            (dict(t_words=plan.t_words[1:]), "t_words"),
            (dict(t_words=None), "one walk only")):
        with pytest.raises(ValueError, match=match):
            att_bsr.att_sums(dataclasses.replace(plan, **bad), cpart, rpart)
    buf = torch.zeros(cpart.numel() + 4, device=cuda)
    off = buf[1:1 + cpart.numel()].view(cpart.shape)
    with pytest.raises(ValueError, match="16-byte"):
        att_bsr.att_sums(plan, off, rpart)
    assert att_bsr.att_sums.launches == before


# --- K5 on the plan's live list -------------------------------------------

def _k5live_operands(rng, edge, feat):
    """K5's operands at ``edge`` (four tile rows, a sorted tile list
    covering each) and a live list of about 60% of the quadrants, tile 0's
    none (a coverage filler's) and tile 1's all; ``keep`` (K·nq²,) marks
    the listed quadrant ids ``k·nq² + i·nq + j``.  On the CPU."""
    nb, nq = 4, edge // 128
    rows = np.sort(np.concatenate([np.arange(nb), rng.integers(0, nb, 8)]))
    cols = rng.choice([0, 1, 3], len(rows))
    keep = rng.random((len(rows), nq * nq)) < 0.6
    keep[0], keep[1] = False, True
    keep = keep.reshape(-1)
    g, x = (torch.from_numpy(rng.standard_normal(
        (nb * edge, feat)).astype(np.float32)) for _ in range(2))
    return (torch.from_numpy(rows.astype(np.int32)),
            torch.from_numpy(cols.astype(np.int32)),
            torch.from_numpy(np.flatnonzero(keep).astype(np.int32)),
            torch.from_numpy(keep), g, x)


def _by_quadrant(db, edge):
    """(K, E, E) tiles as (K·nq², 128, 128) quadrants in id order."""
    k, nq = db.shape[0], edge // 128
    return db.reshape(k, nq, 128, nq, 128).transpose(2, 3).reshape(
        k * nq * nq, 128, 128)


@pytest.mark.parametrize("feat,aligned", [(40, False), (128, True),
                                          (512, True)])
@pytest.mark.parametrize("edge", [256, 512])
def test_k5live_matches_plain(cuda, edge, feat, aligned):
    """K5 on a live list (a CTA a listed quadrant, the gaps between them
    written as +0 in the same launch) at edges 256 and 512: within the
    tolerance of its plain version with the same list (at F=40 on an
    unaligned g, the 4-byte loads); every listed quadrant bit for bit the
    full grid's, every other one +0 (a whole tile of them, and the gap
    after the last listed id); one launch counted each."""
    rng = np.random.default_rng(edge + feat + 240)
    rows, cols, live, keep, g, x = _k5live_operands(rng, edge, feat)
    rows, cols, live, keep, g, x = (t.to(cuda) for t in (rows, cols, live,
                                                         keep, g, x))
    if not aligned:
        g = _unaligned(g)
    before = dyn_grad_blocks.launches
    with torch.inference_mode():
        got = dyn_grad_blocks(rows, cols, g, x, edge, live)
        full = dyn_grad_blocks(rows, cols, g, x, edge)
        ref = dyn_grad_blocks_plain(rows, cols, g, x, edge, live)
    torch.cuda.synchronize()
    assert dyn_grad_blocks.launches == before + 2
    assert got.shape == (rows.shape[0], edge, edge)
    _close(got, ref)
    q, qf = _by_quadrant(got, edge), _by_quadrant(full, edge)
    assert torch.equal(q[keep], qf[keep])
    dead = q[~keep]
    assert dead.numel() and (dead == 0).all() and not dead.signbit().any()


def test_k5live_inf_only_empty_quadrants_reach(cuda):
    """An inf in g at a row of the lower half of tile row ``rows[1]`` and
    in x at a row of the right half of tile column ``cols[1]``, where every
    quadrant that reads them is off the live list: K5 on the list stays
    finite and equals its plain version with the list, while the full grid
    does not stay finite (no CTA computes an empty quadrant's product)."""
    edge, feat = 256, 128
    rng = np.random.default_rng(249)
    rows, cols, _, keep, g, x = _k5live_operands(rng, edge, feat)
    keep = keep.reshape(-1, 2, 2)
    keep[rows == rows[1], 1, :] = False
    keep[cols == cols[1], :, 1] = False
    keep = keep.reshape(-1)
    live = torch.from_numpy(np.flatnonzero(keep.numpy()).astype(np.int32))
    g[int(rows[1]) * edge + 150, 0] = float("inf")
    x[int(cols[1]) * edge + 200, feat // 2] = float("-inf")
    rows, cols, live, g, x = (t.to(cuda) for t in (rows, cols, live, g, x))
    with torch.inference_mode():
        got = dyn_grad_blocks(rows, cols, g, x, edge, live)
        full = dyn_grad_blocks(rows, cols, g, x, edge)
        ref = dyn_grad_blocks_plain(rows, cols, g, x, edge, live)
    torch.cuda.synchronize()
    assert not torch.isfinite(full).all()
    _close(got, ref)


def test_k5live_refused_where_there_is_no_live_grid(cuda):
    """A live list at edge 128, or one longer than the tiles' quadrants,
    raises: there is no fallback to the full grid."""
    rows = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    cols = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    x = torch.ones((512, 8), device=cuda)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        dyn_grad_blocks(rows, cols, x[:256], x[:256], 128,
                        torch.tensor([0], dtype=torch.int32, device=cuda))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        dyn_grad_blocks(rows, cols, x, x, 256,
                        torch.arange(9, dtype=torch.int32, device=cuda))


def test_k5live_gat_two_stage_step_bit_equal(cuda):
    """One GAT training step (hidden 64, dropout off) on the 256-wide
    ``att_unit`` operator, under PyTorch's deterministic algorithms: K5 on
    the plan's live list gives the loss and every gradient of the step
    with the full grid (the plan's ``live`` removed) bit for bit, and the
    step with the list twice the same; K5 launches twice a step."""
    rng = np.random.default_rng(24)
    n, feat = 1920, 128
    s, r = _bench_like(rng, n=n, e=20_000)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = rng.integers(0, 5, n)
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=rng.random(n) < .5,
                                 min_block_edges=48, layer_name="GATConv")
    h = build_hybrid(g.senders.numpy(), g.receivers.numpy(),
                     g.edge_weight.numpy(), g.num_nodes_padded,
                     min_block_edges=96, block=_EDGE, use_segmm=True,
                     semantics="att_unit")
    plan = h.dyn_plan
    assert plan.live is not None
    assert plan.live.numel() < h.bsr.nnz_blocks * 4        # empty quadrants
    gd = g._replace(aux=h).to(cuda)
    g0 = gd._replace(aux=dataclasses.replace(gd.aux, dyn_plan=dataclasses
                                             .replace(gd.aux.dyn_plan,
                                                      live=None)))
    model = NodeModel("GATConv", feat, 64, 2, 5, dropout_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0)).train()
    model = model.to(cuda)
    before = dyn_grad_blocks.launches
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = [_grads(model, gr, gd.y, gd.train_mask)
                for gr in (gd, g0, gd)]
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    assert dyn_grad_blocks.launches == before + 6
    (loss, grads), *others = runs
    for loss_o, grads_o in others:
        assert torch.equal(loss_o, loss)
        for k, v in grads.items():
            assert torch.isfinite(v).all() and torch.equal(grads_o[k], v), k


# --- GAT's tile opt-ins (use_diag, tile_group, use_rowwalk) and switches ----

# (edge, build_hybrid's opt-ins, bf16 mask, switches, the launches of one
# step at hidden 64 by counter: at 128 → 64 layer 0 aggregates lin(x),
# which needs dx, so every tile kernel runs twice)
_GAT_OPTINS = {
    "diag128": (128, dict(use_diag=True), False, {},
                dict(K4=2, K4T=2, K5=2)),
    "diag128-fused-exact": (128, dict(use_diag=True), False,
                            {"FITGNN_GAT_FUSED_TILES": "1",
                             "FITGNN_GAT_GLOBAL_MAX": "0"},
                            dict(K7rm=2, K7f=2, K7bt=2, K7s=2, K7sums=2)),
    "diag256-exact": (256, dict(use_diag=True), False,
                      {"FITGNN_GAT_GLOBAL_MAX": "0"},
                      dict(K4=2, K4T=2, K5=2)),
    "diag256bf-fused": (256, dict(use_diag=True), True,
                        {"FITGNN_GAT_FUSED_TILES": "1"},
                        dict(K7f=2, K7bt=2, K7s=2, K7sums=2)),
    "group128-fused": (128, dict(tile_group=2), False,
                       {"FITGNN_GAT_FUSED_TILES": "1"},
                       dict(K7f=2, K7bt=2, K7s=2, K7sums=2)),
    "group256": (256, dict(tile_group=2), False, {},
                 dict(K4=2, K4T=2, K5=2)),
    "rowwalk128-fused": (128, dict(use_rowwalk=True), False,
                         {"FITGNN_GAT_FUSED_TILES": "1"}, {})}


def _gat_counts():
    return dict(K4=dyn_tiles, K4T=dyn_tiles_t, K5=dyn_grad_blocks,
                K7rm=att_bsr.att_rowmax, K7f=att_bsr.att_fwd,
                K7bt=att_bsr.att_bwd_t, K7s=att_bsr.att_bwd_scores,
                K7sums=att_bsr.att_sums)


def _launches(counts):
    return {k: fn.launches + getattr(fn, "launches_bf16", 0)
            for k, fn in counts.items()}


def _gat_optin_graph(rng, edge, kw, bf16):
    """A 1,920-node graph (2,048 rows) on ``edge``-node communities, 70% of
    the edges inside (dense diagonal tiles), 15% between communities 4k
    and 4k + 1 (dense off-diagonal tiles, beside the diagonal blocks of
    ``use_diag``; the other block rows hold one tile, so ``tile_group=2``
    pads them), 15% anywhere (stragglers), with GAT's opt-in operator at
    ``edge`` attached (presence weights)."""
    from fitgnn_tpu_torch.graph.build import build_graph
    n, feat, e = 1920, 128, 24_000
    r = rng.integers(0, n, e)
    u = rng.random(e)
    own = r // edge
    blk = np.where((u < 0.7) | (own % 4 != 0), own, own + 1)
    s = np.where(u < 0.85, np.minimum(blk * edge + rng.integers(0, edge, e),
                                      n - 1), rng.integers(0, n, e))
    keep = s != r
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = rng.integers(0, 5, n)
    g = build_graph(x, s[keep], r[keep], y=y, train_mask=rng.random(n) < .5,
                    node_pad_to=256)
    h = build_hybrid(g.senders.numpy(), g.receivers.numpy(),
                     (g.edge_weight.numpy() > 0).astype(np.float32),
                     g.num_nodes_padded, min_block_edges=edge, block=edge,
                     use_segmm=True,
                     tile_dtype=torch.bfloat16 if bf16 else None,
                     semantics="att_unit", **kw)
    assert h.bsr is not None and bool(
        (h.bsr.rows != h.bsr.cols)[h.bsr.blocks.flatten(1).any(1)].any())
    assert (h.dyn_plan is None) == bool(kw.get("use_rowwalk"))
    return g._replace(aux=h)


@pytest.mark.parametrize("case", list(_GAT_OPTINS))
def test_gat_optin_training_on_card_matches_cpu(cuda, monkeypatch, case):
    """One GAT training step (hidden 64, dropout off) on each of GAT's
    opt-in operators: the diagonal blocks beside the off-diagonal tiles
    (two-stage and fused, f32 and bf16 masks, both maxima), the
    group-padded plan and the row walk (no plan: no tile kernel even under
    ``FUSED_TILES=1``); kernels on the card against plain versions on the
    CPU, each tile kernel launched twice."""
    edge, kw, bf16, env, want = _GAT_OPTINS[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    g = _gat_optin_graph(np.random.default_rng(25), edge, kw, bf16)
    model = NodeModel("GATConv", 128, 64, 2, 5, dropout_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0)).train()
    loss_c, grads_c = _grads(model, g, g.y, g.train_mask)
    gd = g.to(cuda)
    counts = _gat_counts()
    before = _launches(counts)
    loss_d, grads_d = _grads(model.to(cuda), gd, gd.y, gd.train_mask)
    torch.cuda.synchronize()
    after = _launches(counts)
    assert {k: after[k] - before[k] for k in counts
            if after[k] != before[k]} == want
    _close(loss_d, loss_c)
    for k, v in grads_c.items():
        _close(grads_d[k], v)


@pytest.mark.parametrize("env", [
    {"FITGNN_GAT_FUSED_BWD": "1"},
    {"FITGNN_GAT_FUSED_BWD": "1", "FITGNN_GAT_FUSED_SORTED_DH": "1"},
    {"FITGNN_GAT_SORTED_NUM": "1", "FITGNN_GAT_SORTED_SRC": "1"}],
    ids=["fused_bwd", "fused_bwd_sorted_dh", "sorted_num_src"])
def test_gat_switches_on_card_match_cpu(cuda, monkeypatch, env):
    """One GAT training step at hidden 256 (every aggregation above
    ``SEGMM_MAXF``, so the switches take their branches) under each
    diagnostic setting: the stragglers in PyTorch, the tiles through K4,
    K4ᵀ and K5; on the card against the CPU."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(26)
    n, feat = 1500, 128
    s, r = _bench_like(rng)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = rng.integers(0, 5, n)
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=rng.random(n) < .5,
                                 min_block_edges=48, layer_name="GATConv")
    model = NodeModel("GATConv", feat, 256, 2, 5, dropout_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0)).train()
    loss_c, grads_c = _grads(model, g, g.y, g.train_mask)
    gd = g.to(cuda)
    before = dyn_tiles.launches
    loss_d, grads_d = _grads(model.to(cuda), gd, gd.y, gd.train_mask)
    torch.cuda.synchronize()
    assert dyn_tiles.launches == before + 2
    _close(loss_d, loss_c)
    for k, v in grads_c.items():
        _close(grads_d[k], v)


# --- f16, fp8 e4m3 and fp8 e5m2 tiles ---------------------------------------

_LOWP = {"f16": torch.float16, "e4m3": torch.float8_e4m3fn,
         "e5m2": torch.float8_e5m2}
_TILE_WRAPPERS = (bsr_spmm_acc, bsr_spmm_fwd, bsr_spmm_grouped,
                  bsr_spmm_rowwalk, diag_spmm, att_bsr.att_rowmax,
                  att_bsr.att_fwd, att_bsr.att_bwd_t, att_bsr.att_bwd_scores)


def _tile_counts() -> dict:
    return {(fn.__name__, attr): getattr(fn, attr) for fn in _TILE_WRAPPERS
            for attr in ("launches", "launches_bf16")}


@pytest.mark.parametrize("opts", [{}, dict(use_diag=True),
                                  dict(use_diag=True, block=256),
                                  dict(use_rowwalk=True),
                                  dict(tile_group=2)],
                         ids=["grid", "diag", "diag256", "rowwalk", "group2"])
@pytest.mark.parametrize("tile_type", list(_LOWP))
def test_lowp_operator_widens_on_card(cuda, tile_type, opts):
    """An operator of f16 or fp8 tiles moved to the card holds its tiles
    and diagonal blocks widened to f32 (the cast values exactly) and runs
    the f32 forms on them: forward and gradient against the plain versions
    on the CPU operator, f32 launches only."""
    rng = np.random.default_rng(360)
    n = 1024
    s, r, w = _coo(rng, n, 20_000)
    w[:4] = [300.0, -200.0, 3e-3, 1e-5]
    hc = build_hybrid(s, r, w, n, min_block_edges=20, use_segmm=True,
                      tile_dtype=_LOWP[tile_type], **opts)
    hd = hc.to(cuda)
    for got, ref in ((hd.bsr.blocks, hc.bsr.blocks),
                     (hd.diag_blocks, hc.diag_blocks)):
        if ref is not None:
            assert got.dtype == torch.float32
            assert torch.equal(got.cpu(), ref.float())
    x = rng.standard_normal((n, 64)).astype(np.float32)
    xc = torch.tensor(x, requires_grad=True)
    xd = torch.tensor(x, device=cuda, requires_grad=True)
    before = _tile_counts()
    out_d = hybrid_spmm(hd, xd)
    out_d.square().sum().backward()
    torch.cuda.synchronize()
    after = _tile_counts()
    out_c = hybrid_spmm(hc, xc)
    out_c.square().sum().backward()
    _close(out_d.detach().cpu(), out_c.detach())
    _close(xd.grad.cpu(), xc.grad)
    grew = {k for k in after if after[k] != before[k]}
    assert grew and all(attr == "launches" for _, attr in grew)


@pytest.mark.parametrize("layer,env", [
    ("GCNConv", {}), ("GATConv", {}),
    ("GATConv", {"FITGNN_GAT_FUSED_TILES": "1"})],
    ids=["gcn", "gat", "gat_fused"])
@pytest.mark.parametrize("tile_type", list(_LOWP))
def test_lowp_train_step_on_card_matches_cpu(cuda, monkeypatch, tile_type,
                                             layer, env):
    """One step's loss and gradients on an operator of f16 or fp8 tiles
    from ``build_optimized_graph``: on the card (the f32 forms on the
    widened tiles) against the plain versions on the CPU operator."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(27)
    n, feat = 1500, 128
    s, r = _bench_like(rng)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = rng.integers(0, 5, n)
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=rng.random(n) < .5,
                                 min_block_edges=48, layer_name=layer,
                                 tile_dtype=_LOWP[tile_type])
    assert g.aux.bsr.blocks.dtype == _LOWP[tile_type]
    model = NodeModel(layer, feat, 64, 2, 5, dropout_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0)).train()
    loss_c, grads_c = _grads(model, g, g.y, g.train_mask)
    gd = g.to(cuda)
    assert gd.aux.bsr.blocks.dtype == torch.float32
    loss_d, grads_d = _grads(model.to(cuda), gd, gd.y, gd.train_mask)
    _close(loss_d, loss_c)
    for k, v in grads_c.items():
        _close(grads_d[k], v)


def test_wrappers_refuse_lowp_tiles_on_card(cuda):
    """A ``BsrMatrix`` made on the card widens f16 tiles; tiles of f16 or
    fp8 handed to a wrapper on the card themselves are refused before a
    launch."""
    rng = np.random.default_rng(350)
    s, r, w = _coo(rng, 512, 4000)
    b = build_bsr(s, r, w, 512).to(cuda)
    assert dataclasses.replace(
        b, blocks=b.blocks.half()).blocks.dtype == torch.float32
    x = torch.zeros((512, 16), device=cuda)
    for dt in _LOWP.values():
        with pytest.raises(ValueError, match="float32"):
            diag_spmm(b.blocks[:4].to(dt), x, 2)


# ---- bf16 activations (the conv stack's dtype=torch.bfloat16) --------------
# K1a / K1bfa, K3a (K3, K3w, K6) and K11a against their plain versions; the
# widened route of every other form; the dense layers' f32 sums; a bf16
# training step on the card against the CPU.  Outputs are bf16 rounded once
# from f32 sums taken in another order, so they may round to neighbouring
# bf16 values: rtol 2⁻⁶ (two bf16 steps where a step is largest, 2⁻⁷ of the
# value) and atol 1e-4·max|ref|; K11a and the widened route's definition
# bit for bit.

BF16 = torch.bfloat16


def _unaligned_narrow(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of bf16 ``x`` starting 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    start = next(i for i in range(8) if (buf.data_ptr() + 2 * i) % 16 == 2)
    view = buf[start:start + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    return view


def _close_bf16(got, ref):
    assert got.dtype == ref.dtype == BF16
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -6,
                               atol=1e-4 * float(ref.float().abs().max()))


def _randn_bf16(rng, shape, cuda, aligned=True):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda).to(BF16)
    return x if aligned else _unaligned_narrow(x)


@pytest.mark.parametrize("feat,aligned", [(16, True), (100, True),
                                          (101, True), (128, True),
                                          (512, True), (128, False)])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("tiles", ["f32", "bf16"])
def test_bf16a_k1_kernel_matches_plain(cuda, tiles, transpose, feat,
                                       aligned):
    """K1a (f32 tiles) and K1bfa (bf16 tiles) on bf16 ``x`` and ``init``,
    forward and on the transpose: F % 8 != 0 and the unaligned views take
    the 2-byte slab path, F=101 the scalar init and stores."""
    rng = np.random.default_rng(feat + 7)
    n = 1024
    s, r, w = _coo(rng, n, 20_000)
    b = build_bsr(s, r, w, n, tile_dtype=BF16 if tiles == "bf16" else None)
    b = (b.transpose if transpose else b).to(cuda)
    x = _randn_bf16(rng, (n, feat), cuda, aligned)
    init = _randn_bf16(rng, (n, feat), cuda, aligned)
    attr = "launches_bfa" if tiles == "bf16" else "launches_a"
    before = (getattr(bsr_spmm_acc, attr), bsr_spmm_acc.launches,
              bsr_spmm_acc.launches_bf16)
    with torch.inference_mode():
        got = bsr_spmm_acc(b, x, init)
        again = bsr_spmm_acc(b, x, init)
        ref = bsr_spmm_acc_plain(b, x, init)
    torch.cuda.synchronize()
    assert (getattr(bsr_spmm_acc, attr), bsr_spmm_acc.launches,
            bsr_spmm_acc.launches_bf16) == (before[0] + 2, *before[1:])
    _close_bf16(got, ref)
    assert torch.equal(got, again)


@pytest.mark.parametrize("feat,aligned", SEGMM_SHAPES)
@pytest.mark.parametrize("form", ["k3", "k3w", "k3w_transpose", "k6"])
def test_bf16a_k3_kernel_matches_plain(cuda, form, feat, aligned):
    """K3a in its three uses: K3, K3w (forward and on the transpose CSR
    with the permutation) and K6, whose ``den`` stays f32 and sums the
    unrounded weights; two launches bit-equal."""
    rng, m, _, w_edge = _segmm_inputs(cuda, feat, True, 3)
    x = _randn_bf16(rng, (1024, feat), cuda, aligned)
    fn = {"k3": segmm_spmm, "k3w": segmm_weighted_raw,
          "k3w_transpose": segmm_weighted_raw,
          "k6": segmm_weighted_den_raw}[form]
    perm = None
    if form == "k3w_transpose":
        perm = torch.from_numpy(rng.permutation(len(w_edge)).astype(
            np.int32)).to(cuda)
    args = {"k3": (m, x), "k3w": (m, w_edge, x),
            "k3w_transpose": (m, w_edge, x, perm),
            "k6": (m, w_edge, x)}[form]
    plain = {"k3": segmm_spmm_plain,
             "k3w": lambda *a: segmm_spmm_plain(
                 m, x, w_edge.float() * m.weights),
             "k3w_transpose": lambda *a: segmm_spmm_plain(
                 m, x, w_edge[perm.long()] * m.weights),
             "k6": segmm_weighted_den_raw_plain}[form]
    before = (fn.launches_a, fn.launches)
    with torch.inference_mode():
        got, again, ref = fn(*args), fn(*args), plain(*args)
    torch.cuda.synchronize()
    assert (fn.launches_a, fn.launches) == (before[0] + 2, before[1])
    if form == "k6":
        (got, den), (again, den2), (ref, den_ref) = got, again, ref
        assert den.dtype == torch.float32 and torch.equal(den, den2)
        torch.testing.assert_close(den, den_ref, rtol=1e-5, atol=1e-6)
    _close_bf16(got, ref)
    assert torch.equal(got, again)
    assert not got[3 * 128:4 * 128].any()          # the empty block


@pytest.mark.parametrize("shape,aligned", [((1000, 512), True),
                                           ((37, 101), True),
                                           ((64, 128), False)])
@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_bf16a_k11_kernel_matches_plain_bit_exact(cuda, shape, aligned,
                                                  rate):
    """K11a equals its plain version exactly, and drops the elements that
    the f32 form drops on the same seed."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x32 = torch.randn(shape, generator=gen, device=cuda) + 10.0
    x = x32.to(BF16)
    x = x if aligned else _unaligned_narrow(x)
    seed = dropout_mod.seed_from_generator(gen, cuda)
    before = (philox_dropout.launches_a, philox_dropout.launches)
    with torch.inference_mode():
        got = philox_dropout(x, seed, rate)
        ref = philox_dropout_plain(x, seed, rate)
        wide = philox_dropout(x32, seed, rate)
    torch.cuda.synchronize()
    assert (philox_dropout.launches_a,
            philox_dropout.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == BF16 and torch.equal(got, ref)
    assert torch.equal(got == 0, wide == 0)


def _widened_cases(cuda, rng):
    """(name, wrapper's counter attribute holder, call on bf16 operands,
    the same call on f32 operands) for each form with a widened route."""
    n = 1024
    s, r, w = _coo(rng, n, 20_000)
    b = {k: build_bsr(s, r, w, n, **kw).to(cuda) for k, kw in (
        ("K2", {}), ("K9", dict(group=2)), ("K10", dict(rowwalk=True)),
        ("K1@256", dict(block=256)))}
    blocks = torch.from_numpy((rng.random((8, 128, 128)) < 0.05).astype(
        np.float32) * rng.random((8, 128, 128)).astype(np.float32)).to(cuda)
    x, init = (_randn_bf16(rng, (n, 64), cuda) for _ in range(2))
    return [
        ("K2", bsr_spmm_fwd, lambda a: bsr_spmm_fwd(b["K2"], a), (x,)),
        ("K9", bsr_spmm_grouped, lambda a: bsr_spmm_grouped(b["K9"], a),
         (x,)),
        ("K10", bsr_spmm_rowwalk, lambda a: bsr_spmm_rowwalk(b["K10"], a),
         (x,)),
        ("K1@256", bsr_spmm_acc,
         lambda a, c: bsr_spmm_acc(b["K1@256"], a, c), (x, init)),
        ("K8", diag_spmm, lambda a, c: diag_spmm(blocks, a, 2, True, c),
         (x, init)),
    ]


def test_bf16a_widened_forms_launch_their_f32_form(cuda):
    """Each form without a bf16-activation form: the bf16 call is its f32
    kernel on the widened operands, rounded once (bit for bit), and counts
    one launch of the f32-activation form."""
    rng = np.random.default_rng(21)
    for name, fn, call, acts in _widened_cases(cuda, rng):
        before = fn.launches
        with torch.inference_mode():
            got = call(*acts)
            ref = call(*(a.float() for a in acts))
        torch.cuda.synchronize()
        assert fn.launches == before + 2, name
        assert torch.equal(got, ref.to(got.dtype)), name
        assert got.dtype == BF16, name


def test_bf16a_other_activation_types_raise(cuda):
    """On the card the kernels take f32 and bf16 activations only."""
    rng = np.random.default_rng(22)
    s, r, w = _coo(rng, 512, 4000)
    b = build_bsr(s, r, w, 512).to(cuda)
    m = build_segmm(s, r, w, 512).to(cuda)
    x = torch.zeros((512, 16), device=cuda, dtype=torch.float16)
    seed = torch.zeros(1, dtype=torch.int32, device=cuda)
    for call in (lambda: bsr_spmm_acc(b, x, x), lambda: bsr_spmm_fwd(b, x),
                 lambda: segmm_spmm(m, x),
                 lambda: philox_dropout(x, seed, 0.5),
                 lambda: diag_spmm(b.blocks[:4], x, 2)):
        with pytest.raises(ValueError, match="ROADMAP.md §3"):
            call()


def test_bf16a_dense_sums_in_f32(cuda, monkeypatch):
    """The dense layers' bf16 products: the same bits whatever
    ``allow_bf16_reduced_precision_reduction`` says (f32 sums), one rounding
    from the float64 product, forward and both gradients."""
    from fitgnn_tpu_torch.models.layers import dense
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((4096, 512), generator=gen, device=cuda).to(BF16)
    w = torch.randn((512, 512), generator=gen, device=cuda) / 20.0
    gy = torch.randn((4096, 512), generator=gen, device=cuda).to(BF16)
    runs = []
    for flag in (True, False):
        monkeypatch.setattr(
            torch.backends.cuda.matmul,
            "allow_bf16_reduced_precision_reduction", flag)
        xx = x.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        y = dense(xx, ww, BF16)
        y.backward(gy)
        runs.append((y, xx.grad, ww.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    y, dx, dw = runs[0]
    assert y.dtype == dx.dtype == BF16 and dw.dtype == torch.float32
    exact = x.double() @ w.to(BF16).double().t()
    torch.testing.assert_close(y.double(), exact, rtol=2 ** -8,
                               atol=1e-4 * float(exact.abs().max()))
    exact_dw = gy.double().t() @ x.double()
    torch.testing.assert_close(dw.double(), exact_dw, rtol=2 ** -8,
                               atol=1e-4 * float(exact_dw.abs().max()))


@pytest.mark.parametrize("layer,env", [
    ("GCNConv", {}), ("SAGEConv", {}), ("GINConv", {}), ("GATConv", {}),
    ("GATConv", {"FITGNN_GAT_FUSED_TILES": "1",
                 "FITGNN_GAT_SEGMM_DEN": "1"})])
@pytest.mark.parametrize("tiles", ["f32", "bf16"])
def test_bf16a_training_on_card_matches_cpu(cuda, monkeypatch, layer, env,
                                            tiles):
    """One step of ``NodeModel(dtype=bf16)`` at hidden 64: the kernels on the
    card against the plain versions on the CPU (loss within 1e-2 relative,
    each gradient within 5e-2·max|ref|, as the CPU tests hold the port to
    the JAX package); the GCN step launches K3a and K1a / K1bfa and no f32
    form of K1 or K3."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(23)
    n, feat = 1500, 128
    s, r = _bench_like(rng, n)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = rng.integers(0, 5, n)
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=rng.random(n) < .5,
                                 min_block_edges=48, layer_name=layer,
                                 tile_dtype=BF16 if tiles == "bf16" else None)
    model = NodeModel(layer, feat, 64, 2, 5, dropout_rate=0.0, dtype=BF16)
    model.reset_parameters(torch.Generator().manual_seed(0)).train()
    loss_c, grads_c = _grads(model, g, g.y, g.train_mask)
    gd = g.to(cuda)
    counts = (bsr_spmm_acc.launches, bsr_spmm_acc.launches_bf16,
              bsr_spmm_acc.launches_a, bsr_spmm_acc.launches_bfa,
              segmm_spmm.launches, segmm_spmm.launches_a)
    loss_d, grads_d = _grads(model.to(cuda), gd, gd.y, gd.train_mask)
    torch.cuda.synchronize()
    if layer == "GCNConv":
        # both layers aggregate lin(·) in bf16, which needs a gradient: two
        # forward, two backward
        k1 = 4
        want = (0, 0, 0 if tiles == "bf16" else k1,
                k1 if tiles == "bf16" else 0, 0, k1)
        got = tuple(c - b for c, b in zip(
            (bsr_spmm_acc.launches, bsr_spmm_acc.launches_bf16,
             bsr_spmm_acc.launches_a, bsr_spmm_acc.launches_bfa,
             segmm_spmm.launches, segmm_spmm.launches_a), counts))
        assert got == want, got
    np.testing.assert_allclose(float(loss_d), float(loss_c), rtol=1e-2)
    for k, v in grads_c.items():
        assert grads_d[k].dtype == torch.float32
        torch.testing.assert_close(grads_d[k], v, rtol=0,
                                   atol=5e-2 * float(v.abs().max()))


# --- K4a, K4ᵀa and K5a: GAT's dynamic tiles on bf16 activations ------------

_DYN_A = {"K4a": dyn_tiles, "K4Ta": dyn_tiles_t, "K5a": dyn_grad_blocks}


def _dyn_a_counts() -> dict:
    return {k: (fn.launches, fn.launches_a) for k, fn in _DYN_A.items()}


def _dyn_a_operands(rng, edge, feat, cuda, aligned=True):
    """On the card: a sorted tile list over four tile rows whose tile
    column 2 is never used (the transpose plan's filler slot); a 0/1 mask
    ~3% full, above 128 with each 128-wide quadrant empty at odds 0.4 and
    quadrant (0, 1) of every tile empty, and the plan with its occupancy
    words and live list there; bf16 ``pe``-like values on the mask; bf16
    ``x`` and ``g`` (``g`` off a 16-byte boundary unless ``aligned``)."""
    nb, nq = 4, edge // 128
    rows = np.sort(np.concatenate([np.arange(nb), rng.integers(0, nb, 8)]))
    cols = rng.choice([0, 1, 3], len(rows))
    k = len(rows)
    empty = rng.random((k, nq, nq)) < (0.4 if nq > 1 else 0.0)
    if nq > 1:
        empty[:, 0, 1] = True
    mask = (rng.random((k, edge, edge)) < 0.03) & ~np.repeat(np.repeat(
        empty, 128, 1), 128, 2)
    mask = torch.from_numpy(mask.astype(np.float32))
    plan = build_dyn_plan(rows, cols, nb, words=quad_words(mask, edge),
                          block=edge)
    assert (plan.live is not None) == (edge > 128)
    pe = torch.where(mask > 0, torch.from_numpy(
        rng.random((k, edge, edge)).astype(np.float32)) + 0.1, 0.0)
    x = _randn_bf16(rng, (nb * edge, feat), cuda)
    g = _randn_bf16(rng, (nb * edge, feat), cuda, aligned)
    return (torch.from_numpy(rows.astype(np.int32)).to(cuda),
            torch.from_numpy(cols.astype(np.int32)).to(cuda), plan.to(cuda),
            pe.to(BF16).to(cuda), x, g)


@pytest.mark.parametrize("feat,aligned", [(16, True), (36, True),
                                          (128, True), (512, True),
                                          (128, False)])
@pytest.mark.parametrize("edge", [128, 256])
@pytest.mark.parametrize("kernel", ["K4a", "K4Ta", "K5a"])
def test_bf16a_dyn_kernels_match_plain(cuda, kernel, edge, feat, aligned):
    """K4a, K4ᵀa (the walks on bf16 tiles and a bf16 slab) and K5a (one
    bf16 tensor-core pass) at edges 128 and 256, F % 8 != 0 and the
    unaligned ``g`` taking the scalar copies: within ``compare_bf16``'s
    bound of their plain versions, bf16, two launches bit-equal, counted
    under ``launches_a`` and no f32 form's; at 256 K4a and K4ᵀa with the
    plan's words bit for bit the walks without them, and K5a on the live
    list bit for bit the full grid on every listed quadrant and +0 on the
    others."""
    rng = np.random.default_rng(edge + feat + 320 + aligned)
    rows, cols, plan, pe, x, g = _dyn_a_operands(rng, edge, feat, cuda,
                                                 aligned)
    fn = _DYN_A[kernel]
    call, plain, without = {
        "K4a": (lambda p: dyn_tiles(rows, cols, p, pe, g),
                lambda p: dyn_tiles_plain(rows, cols, p, pe, g),
                lambda p: dyn_tiles(rows, cols, _no_words(p), pe, g)),
        "K4Ta": (lambda p: dyn_tiles_t(p, pe, g),
                 lambda p: dyn_tiles_t_plain(p, pe, g),
                 lambda p: dyn_tiles_t(_no_words(p), pe, g)),
        "K5a": (lambda p: dyn_grad_blocks(rows, cols, g, x, edge, p.live),
                lambda p: dyn_grad_blocks_plain(rows, cols, g, x, edge,
                                                p.live),
                lambda p: dyn_grad_blocks(rows, cols, g, x, edge))}[kernel]
    before = fn.launches, fn.launches_a
    with torch.inference_mode():
        got, again, ref = call(plan), call(plan), plain(plan)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_a) == (before[0], before[1] + 2)
    _close_bf16(got, ref)
    assert torch.equal(got, again)
    if kernel == "K4Ta":
        assert not got[2 * edge:3 * edge].any()     # the filler's block
    if edge == 128:
        return
    with torch.inference_mode():
        other = without(plan)
    torch.cuda.synchronize()
    if kernel != "K5a":
        assert torch.equal(got, other)
        return
    keep = torch.zeros(rows.shape[0] * 4, dtype=torch.bool, device=cuda)
    keep[plan.live.long()] = True
    q, qf = _by_quadrant(got, edge), _by_quadrant(other, edge)
    assert torch.equal(q[keep], qf[keep])
    dead = q[~keep]
    assert dead.numel() and (dead == 0).all() and not dead.signbit().any()


def test_bf16a_k5a_zero_features_and_exact_products(cuda):
    """K5a at F=0 writes zeros; on bf16 values whose products and sums are
    exact in f32 (small integers) it equals the float64 product, rounded
    to bf16 once."""
    rng = np.random.default_rng(330)
    rows, cols, _, _, _, _ = _dyn_a_operands(rng, 128, 8, cuda)
    empty = torch.zeros((512, 0), dtype=BF16, device=cuda)
    ints = [torch.from_numpy(rng.integers(-8, 9, (512, 96)).astype(
        np.float32)).to(cuda).to(BF16) for _ in range(2)]
    with torch.inference_mode():
        zero = dyn_grad_blocks(rows, cols, empty, empty)
        got = dyn_grad_blocks(rows, cols, *ints)
    torch.cuda.synchronize()
    assert zero.dtype == BF16 and not zero.any()
    exact = dyn_grad_blocks_plain(rows, cols, ints[0].double(),
                                  ints[1].double())
    assert torch.equal(got, exact.to(BF16))


def test_bf16a_dyn_kernels_refuse_mixed_types(cuda):
    """On the card the tiles are in the activations' type and K5's ``g``
    in ``x``'s: f32 tiles with bf16 ``x``, or bf16 ``g`` with f32 ``x``,
    raise (no widened route, no fallback)."""
    rng = np.random.default_rng(331)
    rows, cols, plan, pe, x, g = _dyn_a_operands(rng, 128, 16, cuda)
    with pytest.raises(ValueError, match="blocks"):
        dyn_tiles(rows, cols, plan, pe.float(), x)
    with pytest.raises(ValueError, match="blocks"):
        dyn_tiles_t(plan, pe.float(), g)
    with pytest.raises(ValueError, match="g: expected"):
        dyn_grad_blocks(rows, cols, g, x.float())


@pytest.mark.parametrize("edge", [128, 256])
def test_bf16a_gat_two_stage_step_launches_narrow_forms(cuda, monkeypatch,
                                                        edge):
    """One step of the bf16 two-stage GAT (``NodeModel(dtype=bf16)``,
    hidden 64, dropout off) on a bf16 ``att_unit`` operator with
    ``use_segmm`` (threshold 32 at 128, 48 at 256): the kernels on the card
    against the plain versions on the CPU (loss within 1e-2 relative, each
    gradient within 5e-2·max|ref|); K4a, K4ᵀa and K5a launch twice each
    (hidden 64 < F: layer 0 aggregates lin(x), whose gradient needs dx)
    and no f32 form of K4, K4ᵀ or K5, and ``kernels.widened`` is never
    called."""
    from fitgnn_tpu_torch.ops import kernels
    calls = []
    wide = kernels.widened
    monkeypatch.setattr(kernels, "widened",
                        lambda *a, **k: calls.append(1) or wide(*a, **k))
    rng = np.random.default_rng(332)
    n, feat = 1920, 128
    s, r = _bench_like(rng, n=n, e=20_000)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = rng.integers(0, 5, n)
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=rng.random(n) < .5,
                                 min_block_edges=32, layer_name="GATConv",
                                 tile_dtype=BF16)
    if edge != 128:
        g = g._replace(aux=build_hybrid(
            g.senders.numpy(), g.receivers.numpy(),
            (g.edge_weight.numpy() > 0).astype(np.float32),
            g.num_nodes_padded, min_block_edges=48, block=edge,
            use_segmm=True, semantics="att_unit", tile_dtype=BF16))
    assert g.aux.bsr.bf16 and g.aux.bsr.block == edge
    model = NodeModel("GATConv", feat, 64, 2, 5, dropout_rate=0.0,
                      dtype=BF16)
    model.reset_parameters(torch.Generator().manual_seed(0)).train()
    loss_c, grads_c = _grads(model, g, g.y, g.train_mask)
    gd = g.to(cuda)
    before = _dyn_a_counts()
    calls.clear()
    loss_d, grads_d = _grads(model.to(cuda), gd, gd.y, gd.train_mask)
    torch.cuda.synchronize()
    after = _dyn_a_counts()
    assert {k: (after[k][0] - before[k][0], after[k][1] - before[k][1])
            for k in after} == {k: (0, 2) for k in after}
    assert not calls
    np.testing.assert_allclose(float(loss_d), float(loss_c), rtol=1e-2)
    for k, v in grads_c.items():
        assert grads_d[k].dtype == torch.float32
        torch.testing.assert_close(grads_d[k], v, rtol=0,
                                   atol=5e-2 * float(v.abs().max()))
