"""Occupancy words of tiles wider than 128 against the JAX package, on the
CPU.

``build_bsr`` stores beside tiles of edge 256 one int64 a tile, bit
``i·2 + j`` set where 128 × 128 quadrant (i, j) holds a non-zero; the
walks K1, K2 and K9 then apply the live quadrants alone, and so do their
plain versions.  The same seeded numpy inputs go through both packages:
the words against the quadrant occupancy of the JAX package's own tiles
(``build_bsr(block=256)`` and ``build_hybrid(block=256)``: grid-walk
layout, ``group=2``, both directions, f32 and bf16 tiles); the plain
versions with words against the JAX ``bsr_spmm`` / ``bsr_spmm_acc_raw``
at ``block=256``, whose Pallas kernels run in interpret mode, as the JAX
package's own tests run them on the CPU.  Then what the words decide: a
cleared bit removes exactly its quadrant's product, an inf in ``x`` that
only empty quadrants reach leaves the output finite, −0 is no non-zero
and NaN is one; at edge 128 there are no words.  The words are made of
the tiles whenever a ``BsrMatrix`` is built, so new tiles (``replace``,
``.to``, the artifact cache) never keep old words.

Tolerance: rtol 1e-4 and atol 1e-4·max|ref| (f32 sums in another order;
bf16 tiles with ``x`` rounded sum exact products in f32 as well); the
words themselves exactly; a quadrant's product in float64 to 1e-12.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.pallas.bsr_spmm import build_bsr as jax_build_bsr
from fitgnn_tpu.ops.pallas.bsr_spmm import bsr_spmm as jax_bsr_spmm
from fitgnn_tpu.ops.pallas.bsr_spmm import bsr_spmm_acc_raw

from fitgnn_tpu_torch.ops.bsr_spmm import (bsr_spmm_acc, bsr_spmm_acc_plain,
                                           bsr_spmm_fwd, bsr_spmm_grouped,
                                           bsr_spmm_plain, build_bsr,
                                           quad_words)
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
from fitgnn_tpu_torch.utils.cache import ArtifactCache

torch.set_num_threads(1)

E, H, N = 256, 128, 1280
BF16 = torch.bfloat16
DTYPES = {"f32": (None, None), "bf16": (BF16, jnp.bfloat16)}
LAYOUTS = {"gridwalk": {}, "group2": dict(group=2)}


def close(got, ref):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


def half_coo(rng, n=N, e=6_000, skip_block=2):
    """Receiver-sorted COO on 128-node communities: 85% of the edges inside
    the community, 13% into the next one, 2% anywhere, so that many
    off-diagonal quadrants of the 256-wide tiles stay empty; no edge in
    block row and column ``skip_block`` (of 256: a coverage filler)."""
    r = np.sort(rng.integers(0, n, e))
    u = rng.random(e)
    com = np.where(u < 0.85, r // H, (r // H + 1) % (n // H))
    s = np.where(u < 0.98, com * H + rng.integers(0, H, e),
                 rng.integers(0, n, e))
    keep = (r // E != skip_block) & (s // E != skip_block)
    return s[keep], r[keep], rng.random(e).astype(np.float32)[keep]


def occupancy_words(blocks) -> np.ndarray:
    """The words of the JAX package's (K, 256, 256) tiles, counted here."""
    live = (np.asarray(jnp.asarray(blocks).astype(jnp.float32)) != 0)
    live = live.reshape(-1, 2, H, 2, H).any(axis=(2, 4)).reshape(-1, 4)
    return (live.astype(np.int64) << np.arange(4)).sum(1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("source", ["build_bsr", "build_hybrid"])
def test_words_match_jax_tiles(source, layout, dtype):
    """Each direction's words are the quadrant occupancy of the JAX
    package's tiles, fillers and group pads (word 0) included; the graph
    leaves quadrants of live tiles empty."""
    s, r, w = half_coo(np.random.default_rng(1))
    tt, tj = DTYPES[dtype]
    if source == "build_bsr":
        bt = build_bsr(s, r, w, N, E, tile_dtype=tt, **LAYOUTS[layout])
        bj = jax_build_bsr(s, r, w, N, E, tile_dtype=tj, **LAYOUTS[layout])
    else:
        kw = dict(min_block_edges=8, block=E, use_segmm=True,
                  tile_group=LAYOUTS[layout].get("group", 1))
        bt = build_hybrid(s, r, w, N, tile_dtype=tt, **kw).bsr
        bj = jax_build_hybrid(s, r, w, N, tile_dtype=tj, **kw).bsr
    for mt, mj in ((bt, bj), (bt.transpose, bj.transpose)):
        assert mt.quad_bits.dtype == torch.int64
        want = occupancy_words(mj.blocks)
        np.testing.assert_array_equal(mt.quad_bits.numpy(), want)
        live_tiles = want != 0
        assert (want == 0).any() and (want[live_tiles] != 15).any()


def _pair(layout, dtype, seed):
    s, r, w = half_coo(np.random.default_rng(seed))
    tt, tj = DTYPES[dtype]
    return (build_bsr(s, r, w, N, E, tile_dtype=tt, **LAYOUTS[layout]),
            jax_build_bsr(s, r, w, N, E, tile_dtype=tj, **LAYOUTS[layout]))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("feat", [40, 128])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K9"])
def test_plain_with_words_matches_jax(kernel, feat, dtype):
    """K1's plain version from ``init`` and K2's and K9's from zero, with
    the words, on both directions, against the JAX package's
    ``bsr_spmm_acc_raw`` / ``bsr_spmm`` at ``block=256`` (interpret mode),
    and against the plain version without words; the wrappers take the
    plain versions on CPU tensors and launch nothing."""
    bt, bj = _pair("group2" if kernel == "K9" else "gridwalk", dtype,
                   seed=feat)
    rng = np.random.default_rng(feat + 1)
    x, init = (rng.standard_normal((N, feat)).astype(np.float32)
               for _ in range(2))
    xt, it = torch.from_numpy(x), torch.from_numpy(init)
    for mt, mj in ((bt, bj), (bt.transpose, bj.transpose)):
        bare = dataclasses.replace(mt, words=False)
        if kernel == "K1":
            got = bsr_spmm_acc_plain(mt, xt, it)
            close(got, bsr_spmm_acc_raw(mj, jnp.asarray(x),
                                        jnp.asarray(init)))
            close(got, bsr_spmm_acc_plain(bare, xt, it))
            close(bsr_spmm_acc(mt, xt, it), got)
        else:
            got = bsr_spmm_plain(mt, xt)
            close(got, jax_bsr_spmm(mj, jnp.asarray(x)))
            close(got, bsr_spmm_plain(bare, xt))
            walk = bsr_spmm_grouped if kernel == "K9" else bsr_spmm_fwd
            close(walk(mt, xt), got)
    for walk in (bsr_spmm_acc, bsr_spmm_fwd, bsr_spmm_grouped):
        assert walk.launches == walk.launches_bf16 == 0


@pytest.mark.parametrize("kernel", ["K1", "K2", "K9"])
def test_cleared_bit_removes_exactly_that_quadrant(kernel):
    """Clearing the bit of one live quadrant (i, j) of tile k removes its
    product with slab ``cols[k]·2 + j`` from 128-row block ``rows[k]·2 +
    i``, and nothing else (float64)."""
    bt, _ = _pair("group2" if kernel == "K9" else "gridwalk", "f32", seed=5)
    words = bt.quad_bits
    k = int(np.flatnonzero([bin(int(v)).count("1") >= 2
                            for v in words])[3])
    bit = int(words[k]) & -int(words[k])                  # its lowest bit
    q = bit.bit_length() - 1
    i, j = divmod(q, 2)
    cleared = dataclasses.replace(bt)
    cleared.quad_bits = words.clone()
    cleared.quad_bits[k] ^= bit
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((N, 16)))
    init = torch.from_numpy(rng.standard_normal((N, 16)))

    def run(b):
        if kernel == "K1":
            return bsr_spmm_acc_plain(b, x, init)
        return bsr_spmm_plain(b, x)

    diff = run(bt) - run(cleared)
    want = torch.zeros_like(diff)
    quad = bt.blocks[k, i * H:(i + 1) * H, j * H:(j + 1) * H].double()
    slab = int(bt.cols[k]) * 2 + j
    out = int(bt.rows[k]) * 2 + i
    want[out * H:(out + 1) * H] = quad @ x[slab * H:(slab + 1) * H]
    assert want.abs().max() > 0
    np.testing.assert_allclose(diff.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("kernel", ["K1", "K2", "K9"])
def test_inf_that_only_empty_quadrants_reach_stays_out(kernel):
    """The walk's divergence from the dense product, in the plain version
    with words: an inf in x at a row that only empty quadrants reach (slab
    half 1 of tile column 1, its quadrant column cleared in every tile)
    leaves the output finite and equal to the output with that row at 0;
    the plain version without words, the dense product, gives NaN."""
    bt, _ = _pair("group2" if kernel == "K9" else "gridwalk", "f32", seed=7)
    blocks = bt.blocks.clone()
    blocks[bt.cols == 1, :, H:] = 0
    b = dataclasses.replace(bt, blocks=blocks)
    assert (b.quad_bits != bt.quad_bits).any()
    rng = np.random.default_rng(8)
    x0 = torch.from_numpy(rng.standard_normal((N, 16)).astype(np.float32))
    init = torch.from_numpy(rng.standard_normal((N, 16)).astype(np.float32))
    x = x0.clone()
    x0[3 * H + 50] = 0.0
    x[3 * H + 50] = float("inf")                 # slab 2·1 + 1, row 50

    def run(m, xx):
        if kernel == "K1":
            return bsr_spmm_acc_plain(m, xx, init)
        return bsr_spmm_plain(m, xx)

    got = run(b, x)
    assert torch.isfinite(got).all()
    assert torch.equal(got, run(b, x0))
    assert run(dataclasses.replace(b, words=False), x).isnan().any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_words_count_nan_and_not_negative_zero(dtype):
    """The vote's rule: a quadrant holding only −0 is empty, one holding a
    NaN or a denormal is live; on bf16 tiles the rule is the bits other
    than the sign (``TileRegs<__nv_bfloat16>::any``), on f32 ``e != 0``."""
    tt = DTYPES[dtype][0] or torch.float32
    blocks = torch.zeros((3, E, E), dtype=tt)
    blocks[0, 5, 200] = -0.0                     # quadrant (0, 1): empty
    blocks[0, 130, 3] = float("nan")             # quadrant (1, 0)
    blocks[1, 255, 255] = torch.finfo(tt).tiny / 4   # denormal, (1, 1)
    blocks[2, 0, 0] = -1.0                       # (0, 0)
    assert quad_words(blocks, E).tolist() == [0b0100, 0b1000, 0b0001]
    ints = blocks.view(torch.int16 if tt == BF16 else torch.int32)
    sign = 0x7FFF if tt == BF16 else 0x7FFFFFFF
    live = (ints & sign) != 0
    want = live.reshape(3, 2, H, 2, H).any(4).any(2).reshape(3, 4)
    assert quad_words(blocks, E).tolist() == (
        want.long() << torch.arange(4)).sum(1).tolist()


def test_no_words_at_edge_128():
    """No words at edge 128 on any layout or through ``build_hybrid``, nor
    above 1024 (more than 64 quadrants); at 256 the einsum layout's and
    the words move with ``.to()``."""
    s, r, w = half_coo(np.random.default_rng(2))
    for kw in ({}, dict(group=2), dict(rowwalk=True), dict(einsum=True)):
        b = build_bsr(s, r, w, N, 128, **kw)
        assert b.quad_bits is None and b.transpose.quad_bits is None
    h = build_hybrid(s, r, w, N, min_block_edges=8, use_segmm=True)
    assert h.bsr.block == 128 and h.bsr.quad_bits is None
    assert quad_words(torch.ones((1, 1152, 1152)), 1152) is None
    b = build_bsr(s, r, w, N, E, einsum=True)
    assert b.quad_bits.shape == (b.nnz_blocks,)
    moved = build_bsr(s, r, w, N, E).to(torch.device("meta"))
    assert moved.quad_bits.device.type == "meta"
    assert moved.transpose.quad_bits.device.type == "meta"


@pytest.mark.parametrize("how", ["replace", "cache"])
def test_words_follow_the_tiles(how, tmp_path):
    """New tiles bring their own words: ``dataclasses.replace`` with other
    tiles (here one live quadrant emptied, and the bf16 cast) and a round
    trip through the artifact cache recompute them of the tiles, in both
    directions; ``words=False`` keeps them off."""
    bt, _ = _pair("gridwalk", "f32", seed=9)
    if how == "replace":
        blocks = bt.blocks.clone()
        k = int(np.flatnonzero(bt.quad_bits.numpy() & 1)[0])
        blocks[k, :H, :H] = 0
        got = dataclasses.replace(bt, blocks=blocks)
        assert int(got.quad_bits[k]) == int(bt.quad_bits[k]) & ~1
        half = dataclasses.replace(bt, blocks=bt.blocks.to(BF16))
        pairs = ((got, blocks), (half, half.blocks))
        assert dataclasses.replace(bt, words=False).quad_bits is None
    else:
        cache = ArtifactCache(str(tmp_path))
        cache.save("op", bt)
        got = cache.load("op")
        pairs = ((got, got.blocks), (got.transpose, got.transpose.blocks))
        assert torch.equal(got.quad_bits, bt.quad_bits)
    for m, blocks in pairs:
        np.testing.assert_array_equal(m.quad_bits.numpy(),
                                      occupancy_words(blocks.float()))
