"""Tiles of f16, fp8 e4m3fn and fp8 e5m2 against the JAX package, on the
CPU.

The same seeded numpy inputs go through both packages with ``tile_dtype``
set to ``float16``, ``float8_e4m3fn`` or ``float8_e5m2``: the cast tiles'
bytes (``cast_tiles``: ml_dtypes' rule, NaN above 464 in e4m3fn where
torch saturates) on a sweep through the 448-464 band and ±1e5;
``build_bsr`` / ``build_hybrid`` arrays on the grid-walk, grouped,
row-walk and einsum layouts at edges 128 and 256, ``use_diag`` and a
``cluster_agg`` collapse; each layout's forward and gradient against the
JAX Pallas kernels in interpret mode, each layout on one of the three
types and each type on several layouts (the arithmetic past the cast is
the same f32 product for all three); the refusal of an integer type; the
card's premise that the f32 walk on the widened tiles is the product on
these tiles.  The train steps on these tiles are in
``tests/test_torch_port_tiletypes_steps.py``.  The port's wrappers take
their plain versions because the tensors lie on the CPU.

The rule under test: on these types no layout rounds ``x`` (the Pallas
kernels cast ``x`` only for bf16 tiles; ``jnp.dot`` promotes every other
tile type to f32), so each result is the f32 product on the widened
tiles.  ``x`` is unit normal, so a rounded ``x`` would show.  The JAX
package's einsum layout (and its einsum of the diagonal blocks) refuses
fp8 tiles with a ``TypePromotionError``; the port promotes them, and there
its result is held against the f32 einsum on the widened tiles.

Tolerances: forward and gradient within 1e-5·max|ref| (f32 sums in
another order; NaN exactly where the reference has it); arrays and bytes
exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.hybrid_spmm import hybrid_spmm as jax_hybrid_spmm
from fitgnn_tpu.ops.pallas.bsr_spmm import build_bsr as jax_build_bsr
from fitgnn_tpu.ops.pallas.bsr_spmm import bsr_spmm as jax_bsr_spmm
from fitgnn_tpu.ops.pallas.bsr_spmm import bsr_spmm_acc_raw
from fitgnn_tpu.ops.pallas.diag_spmm import diag_spmm_raw

from fitgnn_tpu_torch.ops.bsr_spmm import (build_bsr, bsr_spmm, bsr_spmm_acc,
                                           card_tiles, cast_tiles,
                                           check_tile_dtype, quad_words)
from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid, hybrid_spmm

from test_torch_port_bf16 import sorted_coo

torch.set_num_threads(1)

# the three types: torch's, the JAX package's, the integer view of a tile
TYPES = {"f16": (torch.float16, jnp.float16, np.int16),
         "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn, np.uint8),
         "e5m2": (torch.float8_e5m2, jnp.float8_e5m2, np.uint8)}
FP8 = ("e4m3", "e5m2")


def close(got, ref, tol=1e-5):
    """Within ``tol``·max|ref| over the finite entries, NaN where the
    reference is NaN (an e4m3 NaN tile entry)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    scale = float(np.abs(ref[~nan]).max(initial=0))
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=0,
                               atol=tol * scale)


def bits(a, kind) -> np.ndarray:
    """A tile array of either package as its raw integers."""
    view = TYPES[kind][2]
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16 if view == np.int16 else torch.uint8
                      ).numpy().view(view)
    return np.asarray(a).view(view)


def widened(a) -> np.ndarray:
    """A tile array of either package as float64."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).astype(np.float64)


def rounded(x: np.ndarray, kind) -> np.ndarray:
    """``x`` rounded to the tile type, as f32: what a rounding walk uses."""
    return np.asarray(jnp.asarray(x).astype(TYPES[kind][1]).astype(
        jnp.float32))


@pytest.mark.parametrize("kind", list(TYPES))
def test_cast_tiles_gives_the_jax_bytes(kind):
    """``cast_tiles`` against ``astype``, byte for byte: five scales of
    normal values, the band 440-470 around e4m3fn's largest value (448)
    and its NaN threshold (464), ±1e5, ±inf, ±NaN, ±0 and subnormals."""
    dt, jdt, _ = TYPES[kind]
    rng = np.random.default_rng(0)
    sweep = np.concatenate([
        rng.standard_normal(20_000) * np.repeat([1e-4, 1e-2, 1, 1e2, 1e4],
                                                4000),
        np.linspace(440, 470, 301), -np.linspace(440, 470, 301),
        [1e5, -1e5, np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 2.0**-9,
         2.0**-10, 3 * 2.0**-10, 6e-8, 65504, 65520, 57344, 61440]]
    ).astype(np.float32)
    got = cast_tiles(torch.from_numpy(sweep), dt)
    assert got.dtype == dt
    np.testing.assert_array_equal(bits(got, kind),
                                  bits(jnp.asarray(sweep).astype(jdt), kind))
    if kind == "e4m3":
        # torch's own cast saturates where ml_dtypes gives NaN
        assert torch.from_numpy(sweep).to(dt).float().isnan().sum() < \
            got.float().isnan().sum()


def test_other_tile_types_raise():
    """An integer, complex or f64 tile type raises ``ValueError`` naming
    the five types (the JAX package would cast GCN's weights to it)."""
    s, r, w = sorted_coo(np.random.default_rng(2), 256, 500)
    for dt in (torch.int8, torch.complex64, torch.float64):
        with pytest.raises(ValueError, match="float8_e4m3fn"):
            check_tile_dtype(dt)
    with pytest.raises(ValueError, match="torch.float16"):
        build_bsr(s, r, w, 256, tile_dtype=torch.int8)
    with pytest.raises(ValueError, match="torch.bfloat16"):
        build_hybrid(s, r, w, 256, tile_dtype=torch.int8)


# build_bsr's layouts: (flags, edge)
LAYOUTS = {"gridwalk": ({}, 128), "group2": (dict(group=2), 128),
           "rowwalk": (dict(rowwalk=True), 128),
           "einsum": (dict(einsum=True), 128),
           "gridwalk256": ({}, 256), "group2_256": (dict(group=2), 256),
           "einsum256": (dict(einsum=True), 256)}


def _bsr_pair(kind, layout, seed=1):
    kw, block = LAYOUTS[layout]
    n = 3 * block
    s, r, w = sorted_coo(np.random.default_rng(seed), n, 3000)
    # a few heavy weights: e4m3's NaN and e5m2's coarse steps show
    w[:5] = [500.0, -470.0, 300.0, 1e4, 3e-3]
    dt, jdt, _ = TYPES[kind]
    return (build_bsr(s, r, w, n, block, tile_dtype=dt, **kw),
            jax_build_bsr(s, r, w, n, block, tile_dtype=jdt, **kw))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", list(TYPES))
def test_build_bsr_matches_jax(kind, layout):
    """Blocks (type and bytes), rows, cols and row_splits of both
    directions; above 128 the occupancy words are those of the JAX
    package's cast tiles (a quadrant whose values all flush to zero is
    empty)."""
    bt, bj = _bsr_pair(kind, layout)
    for mt, mj in ((bt, bj), (bt.transpose, bj.transpose)):
        assert mt.blocks.dtype == TYPES[kind][0]
        assert mj.blocks.dtype == TYPES[kind][1]
        np.testing.assert_array_equal(bits(mt.blocks, kind),
                                      bits(mj.blocks, kind))
        for name in ("rows", "cols", "row_splits"):
            np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                          np.asarray(getattr(mj, name)),
                                          err_msg=name)
        if mt.block > 128:
            live = torch.from_numpy(widened(mj.blocks) != 0)
            want = quad_words(live.float(), mt.block)
            np.testing.assert_array_equal(mt.quad_bits.numpy(),
                                          want.numpy())
        else:
            assert mt.quad_bits is None


def _jax_product(bj, kind, x):
    """The JAX package's ``bsr_spmm`` and its gradient on a random
    cotangent; on the einsum layout with fp8 tiles (which it refuses) the
    f32 einsum on the widened tiles, the promotion the port applies."""
    if bj.einsum and kind in FP8:
        bj = bj.replace(blocks=bj.blocks.astype(jnp.float32),
                        transpose=bj.transpose.replace(
                            blocks=bj.transpose.blocks.astype(jnp.float32)))
    tgt = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)
    ref = np.asarray(jax_bsr_spmm(bj, jnp.asarray(x)))
    dx = jax.grad(lambda xx: jnp.sum((jax_bsr_spmm(bj, xx) - tgt) ** 2))(
        jnp.asarray(x))
    return ref, np.asarray(dx), tgt


@pytest.mark.parametrize("kind,layout", [
    ("e4m3", "gridwalk"), ("f16", "group2"), ("e5m2", "rowwalk"),
    ("e4m3", "einsum"), ("f16", "einsum"), ("e5m2", "gridwalk256")])
def test_bsr_spmm_matches_jax(kind, layout):
    """``bsr_spmm`` forward and gradient (K2, K9, K10 or the einsum by the
    layout) against the JAX ``bsr_spmm`` in interpret mode; the JAX result
    is the dense product of the widened tiles with ``x`` as it is, held
    apart from the product with ``x`` rounded to the tile type; K1
    (``bsr_spmm_acc``) on the grid-walk layout against
    ``bsr_spmm_acc_raw``."""
    bt, bj = _bsr_pair(kind, layout)
    n = bt.num_row_blocks * bt.block
    x = np.random.default_rng(4).standard_normal((n, 16)).astype(np.float32)
    ref, dx, tgt = _jax_product(bj, kind, x)
    xt = torch.tensor(x, requires_grad=True)
    out = bsr_spmm(bt, xt)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    close(out, ref)
    close(xt.grad, dx)
    a = np.zeros((n, n))
    e = bt.block
    for blk, rr, cc in zip(widened(bt.blocks), bt.rows.numpy(),
                           bt.cols.numpy()):
        a[rr * e:(rr + 1) * e, cc * e:(cc + 1) * e] += blk
    if not np.isnan(a).any():
        close(ref, a @ x)
        scale = float(np.abs(ref).max())
        assert np.abs(ref - a @ rounded(x, kind)).max() > 10 * 1e-5 * scale
    else:
        # an e4m3 NaN tile entry stays in its own output row
        assert np.array_equal(np.isnan(ref).any(1), np.isnan(a).any(1))
    if layout in ("gridwalk", "gridwalk256"):
        init = np.random.default_rng(6).standard_normal(x.shape).astype(
            np.float32)
        close(bsr_spmm_acc(bt, torch.from_numpy(x), torch.from_numpy(init)),
              bsr_spmm_acc_raw(bj, jnp.asarray(x), jnp.asarray(init)))


@pytest.mark.parametrize("kind,transpose,edge", [
    ("f16", False, 128), ("f16", True, 256), ("e4m3", False, 256),
    ("e4m3", True, 128), ("e5m2", False, 128), ("e5m2", True, 256)])
def test_diag_spmm_matches_jax(kind, transpose, edge):
    """K8 on diagonal blocks of the type, from init, both orientations, x
    as it is, against ``diag_spmm_raw`` in interpret mode."""
    dt, jdt, _ = TYPES[kind]
    rng = np.random.default_rng(7)
    nb = 2
    blocks = (rng.standard_normal((nb, edge, edge))
              * (rng.random((nb, edge, edge)) < 0.1)).astype(np.float32)
    x = rng.standard_normal((nb * edge, 16)).astype(np.float32)
    init = rng.standard_normal((nb * edge, 16)).astype(np.float32)
    bt = cast_tiles(torch.from_numpy(blocks), dt)
    bjx = jnp.asarray(blocks).astype(jdt)
    np.testing.assert_array_equal(bits(bt, kind), bits(bjx, kind))
    got = diag_spmm(bt, torch.from_numpy(x), 2, transpose=transpose,
                    init=torch.from_numpy(init))
    ref = diag_spmm_raw(bjx, jnp.asarray(x), 2, transpose=transpose,
                        init=jnp.asarray(init))
    close(got, ref)
    a = widened(bt)
    a = a.transpose(0, 2, 1) if transpose else a
    prod = np.einsum("bij,bjf->bif", a, x.reshape(nb, edge, 16))
    close(ref, prod.reshape(-1, 16) + init)


# build_hybrid's opt-ins on the three types: (flags, the JAX package runs
# it on fp8 tiles)
HYBRID = {"diag128": (dict(use_diag=True), True),
          "diag256": (dict(use_diag=True, block=256), True),
          "diag_einsum": (dict(use_diag=True, diag_r=0), False),
          "cluster_agg": (dict(cluster_agg=128, cluster_agg_exact=4), True)}


@pytest.mark.parametrize("kind,case", [
    ("e4m3", "diag128"), ("f16", "diag256"), ("e5m2", "diag_einsum"),
    ("e4m3", "cluster_agg")])
def test_hybrid_matches_jax(kind, case):
    """``build_hybrid``'s arrays (the tiles, the diagonal blocks, the
    collapse table in the tile type; bytes exactly) and ``hybrid_spmm``'s
    forward and gradient against the JAX package's.  The diagonal's einsum
    branch (``diag_r=0``) the JAX package refuses on fp8: there the port's
    is held against the f32 product of the widened blocks."""
    flags, jax_runs = HYBRID[case]
    dt, jdt, _ = TYPES[kind]
    n = 512
    s, r, w = sorted_coo(np.random.default_rng(8), n, 4000)
    kw = dict(flags, min_block_edges=20, use_segmm=True)
    ht = build_hybrid(s, r, w, n, tile_dtype=dt, **kw)
    hj = jax_build_hybrid(s, r, w, n, tile_dtype=jdt, **kw)
    for at, aj in ((ht.bsr.blocks, hj.bsr.blocks),
                   (ht.diag_blocks, hj.diag_blocks),
                   (ht.cluster_count, hj.cluster_count)):
        assert (at is None) == (aj is None)
        if at is not None:
            assert at.dtype == dt
            np.testing.assert_array_equal(bits(at, kind), bits(aj, kind))
    x = np.random.default_rng(9).standard_normal((n, 16)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    out = hybrid_spmm(ht, xt)
    (out * torch.arange(16.0)).sum().backward()
    if not jax_runs and kind in FP8:
        widen = dict(tile_dtype=None)
        hf = build_hybrid(s, r, w, n, **kw, **widen)
        hf.bsr = ht.bsr
        hf.diag_blocks = ht.diag_blocks.float()
        xf = torch.tensor(x, requires_grad=True)
        ref_out = hybrid_spmm(hf, xf)
        (ref_out * torch.arange(16.0)).sum().backward()
        close(out, ref_out.detach().numpy())
        close(xt.grad, xf.grad.numpy())
        return
    ref = np.asarray(jax_hybrid_spmm(hj, jnp.asarray(x)))
    dx = jax.grad(lambda xx: jnp.sum(jax_hybrid_spmm(hj, xx)
                                     * jnp.arange(16.0)))(jnp.asarray(x))
    close(out, ref)
    close(xt.grad, dx)


@pytest.mark.parametrize("kind", list(TYPES))
def test_widened_tiles_give_the_same_products(kind):
    """The card holds f16 and fp8 tiles widened to f32 (``card_tiles``)
    and runs the f32 walks on them: on every layout that walk, the
    diagonal's K8 and GAT's mask reads give the product on the tiles of
    the type bit for bit (here through the plain versions); a CPU
    operator keeps its type."""
    dt = TYPES[kind][0]
    n = 512
    s, r, w = sorted_coo(np.random.default_rng(8), n, 4000)
    w[:3] = [500.0, 1e4, 3e-3]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (n, 16)).astype(np.float32))
    for kw in (dict(use_diag=True), dict(use_rowwalk=True),
               dict(tile_group=2), dict(use_einsum_tiles=True),
               dict(use_diag=True, block=256)):
        h = build_hybrid(s, r, w, n, min_block_edges=20, use_segmm=True,
                         tile_dtype=dt, **kw)
        assert card_tiles(h.bsr.blocks) is h.bsr.blocks
        assert h.bsr.blocks.dtype == dt
        wide = dataclasses.replace(h, bsr=dataclasses.replace(
            h.bsr, blocks=h.bsr.blocks.float()), diag_blocks=None
            if h.diag_blocks is None else h.diag_blocks.float())
        np.testing.assert_array_equal(hybrid_spmm(wide, x).numpy(),
                                      hybrid_spmm(h, x).numpy())
        if h.bsr.quad_bits is not None:
            np.testing.assert_array_equal(wide.bsr.quad_bits.numpy(),
                                          h.bsr.quad_bits.numpy())
