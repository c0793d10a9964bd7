"""Block-sparse (BCSR) SpMM: the tile walks K1, K2, K9 and K10.

Community-reordered adjacency is block-sparse: most edges land in a few
dense E×E tiles (E = ``block``, 128 by default, any multiple of 128).
``blocks[k]`` is tile ``(rows[k], cols[k])`` and adds ``A_k · X[cols[k]]``
into block-row ``rows[k]``.  ``build_bsr`` makes the JAX package's four
layouts: the grid-walk layout (every block row holds at least one tile,
zero coverage fillers where it had none), the group-padded layout
(``group > 1``: every row's run zero-padded to a multiple of ``group``),
the row-walk layout (``rowwalk``: no fillers; 128-wide tiles only, as in
the JAX package) and the einsum layout (``einsum``: no fillers either).
Its tiles are f32, or of the type ``tile_dtype`` names (bf16, f16, fp8
e4m3fn or fp8 e5m2), built in f32 and then cast as the JAX package casts
them (``cast_tiles``).

* ``bsr_spmm_acc(b, x, init)`` = ``init + A·x``: K1 on the grid-walk
  layout, ``init + bsr_spmm(...)`` on the others, as the JAX package's
  ``bsr_spmm_acc_raw``.
* ``bsr_spmm(b, x)`` = ``A·x``, differentiable in ``x``: dispatched by the
  layout as the JAX package's ``_fwd_dispatch``, to K10 (row walk,
  ``bsr_spmm_rowwalk``), K9 (grouped, ``bsr_spmm_grouped``) or K2
  (``bsr_spmm_fwd``), or the einsum layout's ``bsr_spmm_einsum``; its
  backward runs the same dispatch on ``b.transpose``.

Each of the four wrappers launches its hand-written kernel through its C
entry in ``csrc/bsr_spmm.cu`` on a CUDA tensor (they replace the TPU
kernels ``_kernel_acc``, ``_kernel``, ``_make_grouped_kernel`` and
``_rowwalk_kernel`` of ``fitgnn_tpu/ops/pallas/bsr_spmm.py``).  All four
launch one kernel, the walk of each tile's non-zeros in
``csrc/tile_sparse.cuh``, which starts from ``init`` for K1 and from zero
for the others; the source notes say what bounds it on an H100 and what
the design does about it.  On a CPU tensor each runs the plain version
(``bsr_spmm_acc_plain``, ``bsr_spmm_plain``: a batched matmul over the
gathered X slabs, then ``index_add_`` over block rows).  Each has its own
``launches`` count.  At an edge above 128 (K1, K2 and K9; K10 is
128-wide only) the walk takes each tile as 128-wide quadrants, and the
same counts count it.

Occupancy words: above 128 (up to 1024) a ``BsrMatrix`` makes
``quad_bits`` of its tiles when it is built, one int64 a tile with bit
``i·nq + j`` set where quadrant (i, j) of 128 × 128 holds a non-zero
(``quad_words``; ``nq = block / 128``), the transpose its own.  K1, K2
and K9 hand them to the walk, which then reads and applies the live
quadrants alone; the plain versions apply the same quadrants.  A
``BsrMatrix`` built with ``words=False`` (``quad_bits`` None) walks every
quadrant.

bf16 tiles: each wrapper launches the walk's bf16 form on them (the C
entries ending in ``_bf16``) and counts it in ``launches_bf16``.  The
rounding is the Pallas kernels': K1, K2 and K9 round ``x`` to bf16 and sum
the exact bf16 × bf16 products in f32; K10's ``jnp.dot`` of a bf16 tile
and an f32 slab promotes the tile, so it leaves ``x`` as it is.  The
plain versions apply the same rule.  The einsum layout is the JAX
package's XLA path (``_bsr_spmm_einsum``), plain PyTorch here on either
device: ``x`` rounded to the tile type, one ``bmm`` whose tile products
are rounded to it, ``index_add_`` in it, then f32.

bf16 activations (the JAX package's conv-stack ``dtype=bfloat16``): ``x``,
``init`` and the output are bf16.  K1 on the grid-walk layout at edge 128
launches its bf16-activation forms (C entries ``fitgnn_bsr_spmm_acc_a``
and ``_a_bf16``; counted in ``bsr_spmm_acc.launches_a`` on f32 tiles,
K1a, and ``launches_bfa`` on bf16 tiles, K1bfa): the slab read as bf16,
each tile's products summed in f32 from ``init`` and the sum rounded to
bf16 once, where the Pallas kernel rounds each tile's product into its
bf16 output block (``ROADMAP.md`` §3).  Every other form (K1 at an edge
above 128, K2, K9, K10) takes the widened route (``kernels.widened``):
``x`` widened to f32, the f32-activation form launched and counted as
usual, the output rounded to bf16 once.  The plain versions follow the
same rules.  The einsum layout stays the JAX package's XLA path: on f32
tiles the product promotes the bf16 slabs to f32 and rounds the sum once.

f16, fp8 e4m3fn and fp8 e5m2 tiles: the Pallas kernels round ``x`` only
on bf16 tiles; on any other type ``jnp.dot`` and ``jnp.einsum`` promote
the tile to f32.  So every layout, the einsum one included, leaves ``x``
in f32 and widens each tile value to f32 exactly: the result is the f32
walk's on ``blocks.float()``.  So such tiles are widened to f32 once, when
a ``BsrMatrix`` is made on the card or moved there (``card_tiles``), and
every wrapper launches its f32 form on them; the plain versions widen
them on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from fitgnn_tpu_torch.ops import kernels
from fitgnn_tpu_torch.utils.device import dataclass_to

BLOCK = 128  # default node-block edge length: one dense tile
MAX_WORD_QUADS = 8  # quadrants a side an int64 occupancy word covers

# the tile types besides f32 (``tile_dtype=None``), as the JAX package's
# ``tile_dtype`` takes them
FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
TILE_DTYPES = (torch.bfloat16, torch.float16) + FP8
# the types whose tiles the card holds widened to f32 (``card_tiles``)
WIDENED = (torch.float16,) + FP8
# |v| above which ml_dtypes' f32 -> e4m3fn cast gives NaN (the tie at 464
# rounds to even, 448); torch's cast saturates at 448 instead
_E4M3_NAN_ABOVE = 464.0


@dataclasses.dataclass
class BsrMatrix:
    """Dense-block BCSR adjacency. ``blocks[k]`` is tile (rows[k], cols[k])."""

    blocks: torch.Tensor        # (K, block, block) f32 or TILE_DTYPES values
    rows: torch.Tensor          # (K,) int32 block-row id, sorted ascending
    cols: torch.Tensor          # (K,) int32 block-col id
    num_row_blocks: int
    num_col_blocks: int
    transpose: Optional["BsrMatrix"] = None   # Aᵀ for the backward pass
    row_splits: Optional[torch.Tensor] = None  # (NB+1,) int32 CSR pointers
    rowwalk: bool = False       # row-walk layout: no coverage fillers (K10)
    group: int = 1              # every row's run padded to a multiple (K9)
    einsum: bool = False        # the einsum layout: no coverage fillers
    block: int = BLOCK          # tile edge E, a multiple of 128
    words: bool = True          # occupancy words for the walk (E > 128)
    # (K,) int64 occupancy words of ``blocks`` (``quad_words``), or None
    quad_bits: Optional[torch.Tensor] = dataclasses.field(init=False,
                                                          default=None)

    def __post_init__(self):
        # The words are made of the tiles here and nowhere else, so a new
        # ``blocks`` (``dataclasses.replace``, ``.to``) gets its own; a
        # cache's packed tiles (not a tensor) get none until unpacked.
        self.blocks = card_tiles(self.blocks)
        if self.words and isinstance(self.blocks, torch.Tensor):
            self.quad_bits = quad_words(self.blocks, self.block)

    @property
    def bf16(self) -> bool:
        return self.blocks.dtype == torch.bfloat16

    @property
    def nnz_blocks(self) -> int:
        return self.blocks.shape[0]

    def to(self, device) -> "BsrMatrix":
        return dataclass_to(self, device)


def check_tile_dtype(tile_dtype) -> None:
    """Tiles are f32 (``None``) or one of ``TILE_DTYPES``.  Any other type
    raises: the JAX package would cast GCN's weights to it, so an integer
    type would truncate them to zero (ROADMAP.md §3)."""
    if tile_dtype is not None and tile_dtype not in TILE_DTYPES:
        raise ValueError(
            f"tile_dtype={tile_dtype!r}: tiles are None (f32), "
            "torch.bfloat16, torch.float16, torch.float8_e4m3fn or "
            "torch.float8_e5m2")


def cast_tiles(t: torch.Tensor, tile_dtype) -> torch.Tensor:
    """f32 values ``t`` in the tile type, bit for bit as the JAX package's
    ``astype`` (ml_dtypes) gives them: torch's cast, but on fp8 e4m3fn a
    magnitude above 464, an inf or a NaN gives NaN (``0x7f`` with the
    sign) where torch saturates at ±448, and on fp8 e5m2 a NaN is ``0x7e``
    with the sign where torch gives ``0x7f``.  ``None`` leaves ``t``."""
    if tile_dtype is None:
        return t
    out = t.to(tile_dtype)
    if tile_dtype in FP8:
        if tile_dtype == torch.float8_e4m3fn:
            nan = ~(t.abs() <= _E4M3_NAN_ABOVE)
            code = 0x7f
        else:
            nan = torch.isnan(t)
            code = 0x7e
        bits = out.view(torch.uint8)
        sign = torch.signbit(t).to(torch.uint8) << 7
        out = torch.where(nan, sign | code, bits).view(tile_dtype)
    return out


def tile_nonzero(blocks: torch.Tensor) -> torch.Tensor:
    """``e != 0`` of every tile entry on any tile type and device (fp8 by
    its bits other than the sign: −0 is zero, NaN counts, as ``!=`` on the
    wider types)."""
    if blocks.dtype in FP8:
        return (blocks.view(torch.uint8) & 0x7f) != 0
    return blocks != 0


def card_tiles(t):
    """Tiles as the card's kernels take them: f16 and fp8 tiles on a CUDA
    device widened to f32 (exact), anything else as it is.  The JAX
    package's kernels promote such a tile to f32 and leave ``x`` alone, so
    the f32 walk on the widened tiles computes their function."""
    if (isinstance(t, torch.Tensor) and t.device.type == "cuda"
            and t.dtype in WIDENED):
        return t.float()
    return t


def tile_values(blocks: torch.Tensor) -> torch.Tensor:
    """The tiles as a type that arithmetic and comparisons take on every
    device: fp8 widened to f32 (exact), the others as they are."""
    return blocks.float() if blocks.dtype in FP8 else blocks


def check_block(block: int) -> None:
    """A tile edge is a positive multiple of 128 (Mosaic's tile needs it on
    the TPU, the quadrant walk on the GPU)."""
    if block <= 0 or block % BLOCK:
        raise ValueError(f"tile edge block={block} must be a positive "
                         f"multiple of {BLOCK}")


def quad_words(blocks: torch.Tensor, block: int) -> Optional[torch.Tensor]:
    """The occupancy words of (K, block, block) tiles: (K,) int64, bit
    ``i·nq + j`` set where 128 × 128 quadrant (i, j) holds an entry that
    the walk's vote counts (``e != 0``: −0 is zero, NaN counts; on bf16
    tiles the same as the bits other than the sign), ``nq = block / 128``.
    None at 128 and above 1024 (nq² > 64 bits)."""
    nq = block // BLOCK
    if not 1 < nq <= MAX_WORD_QUADS:
        return None
    live = tile_nonzero(blocks).reshape(-1, nq, BLOCK, nq, BLOCK).any(
        4).any(2)
    shift = torch.arange(nq * nq, dtype=torch.int64, device=blocks.device)
    return (live.reshape(-1, nq * nq).long() << shift).sum(1)


def build_bsr(senders: np.ndarray, receivers: np.ndarray, weight: np.ndarray,
              num_nodes_padded: int, block: int = BLOCK,
              with_transpose: bool = True, *, tile_dtype=None,
              rowwalk: bool = False, group: int = 1,
              einsum: bool = False) -> BsrMatrix:
    """Host-side BCSR construction from a COO edge list (numpy): the same
    blocks, rows, cols and row_splits as the JAX package's ``build_bsr``
    with the same ``block``, ``tile_dtype``, ``rowwalk``, ``group`` and
    ``einsum``, and a transpose built with the same edge and flags;
    above 128 each direction's occupancy words (``quad_words``) of its
    tiles in their final type, fillers and pads included.
    ``block`` must be a multiple of 128 (``ValueError``), and 128 under
    ``rowwalk``, as the JAX package's row walk refuses another edge.

    ``num_nodes_padded`` must be a multiple of ``block``.  Edges pointing
    at padding slots are harmless as long as their weight is 0."""
    check_block(block)
    if rowwalk and block != BLOCK:
        # the row walk's out tiles and slab offsets are 128-wide, in both
        # packages
        raise ValueError(f"rowwalk supports block={BLOCK} only, got {block}")
    check_tile_dtype(tile_dtype)
    if group < 1:
        raise ValueError(f"build_bsr: group must be >= 1, got {group}")
    dtype = np.float32
    if num_nodes_padded % block:
        raise ValueError(f"num_nodes_padded={num_nodes_padded} is not a "
                         f"multiple of block={block}")
    nb = num_nodes_padded // block
    brow = receivers // block
    bcol = senders // block
    key = brow.astype(np.int64) * nb + bcol
    uniq, inv = np.unique(key, return_inverse=True)
    k = uniq.shape[0]
    blocks = np.zeros((max(k, 1), block, block), dtype=dtype)
    np.add.at(blocks, (inv, receivers % block, senders % block),
              weight.astype(dtype))
    rows = (uniq // nb).astype(np.int32)
    cols = (uniq % nb).astype(np.int32)
    if k == 0:
        rows = np.zeros(1, dtype=np.int32)
        cols = np.zeros(1, dtype=np.int32)
    if not rowwalk and not einsum:
        # coverage fillers: the TPU grid leaves an unvisited out block
        # uninitialized, so every block-row gets ≥1 (zero) tile.  The CUDA
        # walks write every row themselves; the fillers stay for parity and
        # cost one zero tile each.  The row walk and einsum have none.
        missing = np.setdiff1d(np.arange(nb, dtype=np.int32), rows)
        if missing.size:
            blocks = np.concatenate(
                [blocks, np.zeros((missing.size, block, block), dtype=dtype)])
            rows = np.concatenate([rows, missing])
            cols = np.concatenate([cols, np.zeros(missing.size, np.int32)])
            order = np.argsort(rows, kind="stable")
            blocks, rows, cols = blocks[order], rows[order], cols[order]
    if group > 1 and not rowwalk:
        # every row's run zero-padded to a multiple of ``group``; the pads
        # reuse the row's first column id (a zero product on a real slab)
        counts = np.bincount(rows, minlength=nb)      # ≥1 per row (fillers)
        padded = -(-counts // group) * group
        starts_new = np.concatenate(([0], np.cumsum(padded)))[:-1]
        starts_old = np.concatenate(([0], np.cumsum(counts)))[:-1]
        new_blocks = np.zeros((int(padded.sum()), block, block), dtype=dtype)
        new_rows = np.repeat(np.arange(nb, dtype=np.int32), padded)
        new_cols = np.repeat(cols[starts_old], padded)
        idx = starts_new[rows] + (np.arange(rows.size) - starts_old[rows])
        new_blocks[idx] = blocks
        new_cols[idx] = cols
        blocks, rows, cols = new_blocks, new_rows, new_cols

    t = None
    if with_transpose:
        t = build_bsr(receivers, senders, weight, num_nodes_padded, block,
                      with_transpose=False, tile_dtype=tile_dtype,
                      rowwalk=rowwalk, group=group, einsum=einsum)
    row_splits = np.searchsorted(rows, np.arange(nb + 1)).astype(np.int32)
    return BsrMatrix(
        blocks=cast_tiles(torch.from_numpy(blocks), tile_dtype),
        rows=torch.from_numpy(rows), cols=torch.from_numpy(cols),
        num_row_blocks=nb, num_col_blocks=nb,
        transpose=t, row_splits=torch.from_numpy(row_splits),
        rowwalk=rowwalk, group=group, einsum=einsum, block=block)


def round_x(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the walk of ``b``'s layout multiplies it: rounded to bf16
    (and held in f32, exactly) on bf16 tiles, except in the row walk (K10),
    whose TPU kernel promotes the tile instead; as it is on every other
    tile type."""
    if b.bf16 and not b.rowwalk:
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def _tile_sum(b: BsrMatrix, x: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
    """``out += A·x`` in place on an (N_pad, F) ``out``: gather the (K,
    block, F) X slabs, one batched matmul, ``index_add_`` over block rows;
    x rounded as the walk rounds it, the tiles widened to x's type.  With
    occupancy words, the (L, 128, 128) live quadrants alone against their
    128-row slabs, as the walk applies them."""
    if b.quad_bits is not None:
        return _quad_sum(b, round_x(b, x), out)
    n, feat = x.shape
    xb = round_x(b, x).reshape(b.num_col_blocks, b.block, feat)
    prod = torch.bmm(b.blocks.to(x.dtype), xb.index_select(0, b.cols.long()))
    return out.reshape(b.num_row_blocks, b.block, feat).index_add_(
        0, b.rows.long(), prod).reshape(n, feat)


def _quad_sum(b: BsrMatrix, x: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
    """``_tile_sum`` over the quadrants whose bit is set in ``b.quad_bits``
    (x already rounded): quadrant (i, j) of tile k adds its product with
    128-row slab ``cols[k]·nq + j`` into 128-row block ``rows[k]·nq + i``."""
    n, feat = x.shape
    nq = b.block // BLOCK
    shift = torch.arange(nq * nq, device=b.quad_bits.device)
    k, ij = ((b.quad_bits.unsqueeze(1) >> shift) & 1).nonzero(as_tuple=True)
    i, j = ij // nq, ij % nq
    tiles = tile_values(b.blocks).reshape(-1, nq, BLOCK, nq, BLOCK)[
        k, i, :, j, :]
    slabs = x.reshape(-1, BLOCK, feat).index_select(
        0, b.cols.long()[k] * nq + j)
    return out.reshape(-1, BLOCK, feat).index_add_(
        0, b.rows.long()[k] * nq + i,
        torch.bmm(tiles.to(x.dtype), slabs)).reshape(n, feat)


def bsr_spmm_acc_plain(b: BsrMatrix, x: torch.Tensor,
                       init: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``init + A·x`` (K1); on bf16 ``x`` and ``init`` (K1a,
    K1bfa) the sum in f32 over the widened operands, rounded to bf16
    once."""
    if x.dtype == torch.bfloat16:
        return _tile_sum(b, x.float(), init.to(torch.float32,
                                                copy=True)).to(x.dtype)
    return _tile_sum(b, x, init.clone())


def bsr_spmm_plain(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``A·x`` on the grid-walk, grouped and row-walk layouts
    (K2, K9, K10); bf16 ``x`` by the widened route."""
    if x.dtype == torch.bfloat16:
        return kernels.widened(lambda x: bsr_spmm_plain(b, x), x)
    return _tile_sum(b, x, torch.zeros_like(x))


def bsr_spmm_einsum(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A·x`` on the einsum layout, as the JAX package's
    ``_bsr_spmm_einsum``: on bf16 tiles the X slabs in bf16, one batched
    matmul whose tile products come out in bf16, their sum over block rows
    (``index_add_``) in it, then x's type; on any other type the einsum
    promotes the tiles, so the same in f32 on the widened tiles (bf16 ``x``
    promoted to f32 with them, the sum rounded to bf16 once).  Plain
    PyTorch on every device, as XLA computes it there."""
    n, feat = x.shape
    blocks = (b.blocks if b.bf16
              else b.blocks.to(torch.promote_types(x.dtype, torch.float32)))
    xb = x.to(blocks.dtype).reshape(b.num_col_blocks, b.block, feat)
    prod = torch.bmm(blocks, xb.index_select(0, b.cols.long()))
    out = torch.zeros((b.num_row_blocks, b.block, feat), dtype=prod.dtype,
                      device=prod.device)
    return out.index_add_(0, b.rows.long(), prod).reshape(n, feat).to(x.dtype)


def _operands(b: BsrMatrix, x: torch.Tensor, what: str,
              init: Optional[torch.Tensor] = None,
              act: torch.dtype = torch.float32) -> Optional[torch.device]:
    """Validate a walk's operands, ``x`` and ``init`` of type ``act``; the
    CUDA device, or None on the CPU."""
    if x.dim() != 2 or x.shape[0] != b.num_row_blocks * b.block:
        raise ValueError(f"{what}: x {tuple(x.shape)} must be "
                         f"({b.num_row_blocks * b.block}, F)")
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    dev = x.device
    kernels.require(x, "x", act, dev)
    if init is not None:
        kernels.require(init, "init", act, dev)
    kernels.require(b.blocks, "blocks",
                    torch.bfloat16 if b.bf16 else torch.float32, dev)
    kernels.require(b.row_splits, "row_splits", torch.int32, dev)
    kernels.require(b.cols, "cols", torch.int32, dev)
    if b.quad_bits is not None:
        kernels.require(b.quad_bits, "quad_bits", torch.int64, dev)
        if b.quad_bits.shape != (b.nnz_blocks,):
            raise ValueError(f"{what}: quad_bits {tuple(b.quad_bits.shape)}"
                             f" is not ({b.nnz_blocks},)")
    if b.blocks.data_ptr() % 16:
        raise ValueError(f"{what}: blocks must be 16-byte aligned")
    if b.blocks.shape[1:] != (b.block, b.block):
        raise ValueError(f"{what}: blocks {tuple(b.blocks.shape)} are not "
                         f"(K, {b.block}, {b.block})")
    return dev


# blocks, row_splits, cols, words, x, [init,] out, num_row_blocks, feat,
# block, stream
_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGS_ACC = [_PTR] * 7 + [_I64] * 3 + [_PTR]
_ARGS_FWD = [_PTR] * 6 + [_I64] * 3 + [_PTR]


def _launch(b: BsrMatrix, x: torch.Tensor, dev: torch.device, what: str,
            name: str, argtypes: list, ins: list) -> torch.Tensor:
    """Launch C entry ``name`` (its ``_bf16`` twin on bf16 tiles) on the
    tile structure and its occupancy words (null without them), the input
    tensors ``ins`` and a fresh output, then the sizes and the tile
    edge."""
    out = torch.empty_like(x)
    launch = kernels.function("bsr_spmm", kernels.entry(name, b.blocks),
                              argtypes)
    words = None if b.quad_bits is None else kernels.ptr(b.quad_bits)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(b.blocks), kernels.ptr(b.row_splits),
                    kernels.ptr(b.cols), words,
                    *(kernels.ptr(t) for t in ins), kernels.ptr(out),
                    b.num_row_blocks, x.shape[1], b.block,
                    kernels.stream(dev))
    kernels.check(rc, what)
    return out


def bsr_spmm_acc(b: BsrMatrix, x: torch.Tensor,
                 init: torch.Tensor) -> torch.Tensor:
    """``init + A·x`` for (N_pad, F) ``x`` and ``init``.  On the grid-walk
    layout K1 (the walk started from ``init`` on a CUDA tensor, the plain
    version on a CPU tensor); on the row-walk, grouped and einsum layouts
    ``init + bsr_spmm_raw``, so that K10, K9 or the einsum run.  Forward
    only: the hybrid operator's autograd Function runs it on
    ``b.transpose`` for the backward."""
    if init.shape != x.shape:
        raise ValueError(f"bsr_spmm_acc: x {tuple(x.shape)} and init "
                         f"{tuple(init.shape)} differ")
    if b.rowwalk or b.einsum or b.group > 1:
        return init + bsr_spmm_raw(b, x)
    if kernels.narrow("bsr_spmm_acc", x):
        if init.dtype != x.dtype:
            raise ValueError(f"bsr_spmm_acc: init {init.dtype} and x "
                             f"{x.dtype} differ")
        if b.block != BLOCK:
            # the quadrant walk (and its words) has no bf16-activation form
            return kernels.widened(lambda x, init: bsr_spmm_acc(b, x, init),
                                   x, init)
        dev = _operands(b, x, "bsr_spmm_acc", init, torch.bfloat16)
        if dev is None:
            return bsr_spmm_acc_plain(b, x, init)
        out = _launch(b, x, dev, "bsr_spmm_acc", "fitgnn_bsr_spmm_acc_a",
                      _ARGS_ACC, [x, init])
        if b.bf16:
            bsr_spmm_acc.launches_bfa += 1
        else:
            bsr_spmm_acc.launches_a += 1
        return out
    dev = _operands(b, x, "bsr_spmm_acc", init)
    if dev is None:
        return bsr_spmm_acc_plain(b, x, init)
    out = _launch(b, x, dev, "bsr_spmm_acc", "fitgnn_bsr_spmm_acc",
                  _ARGS_ACC, [x, init])
    kernels.count(bsr_spmm_acc, b.blocks)
    return out


def bsr_spmm_fwd(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """K2: ``A·x`` from zero on the grid-walk layout, by the walk of each
    tile's non-zeros; a coverage filler costs only its read."""
    if b.rowwalk or b.einsum or b.group > 1:
        raise ValueError("bsr_spmm_fwd: K2 walks the grid-walk layout, got "
                         f"rowwalk={b.rowwalk} einsum={b.einsum} "
                         f"group={b.group}")
    if kernels.narrow("bsr_spmm_fwd", x):
        return kernels.widened(lambda x: bsr_spmm_fwd(b, x), x)
    dev = _operands(b, x, "bsr_spmm_fwd")
    if dev is None:
        return bsr_spmm_plain(b, x)
    out = _launch(b, x, dev, "bsr_spmm_fwd", "fitgnn_bsr_spmm", _ARGS_FWD,
                  [x])
    kernels.count(bsr_spmm_fwd, b.blocks)
    return out


def bsr_spmm_grouped(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """K9: ``A·x`` from zero on the group-padded layout.  The kernel walks
    each tile's non-zeros and the padded run as a plain run: a zero pad
    costs only its read, and the group is not passed."""
    if b.rowwalk or b.einsum or b.group < 2:
        raise ValueError("bsr_spmm_grouped: K9 walks the group-padded "
                         f"layout, got rowwalk={b.rowwalk} "
                         f"einsum={b.einsum} group={b.group}")
    if kernels.narrow("bsr_spmm_grouped", x):
        return kernels.widened(lambda x: bsr_spmm_grouped(b, x), x)
    dev = _operands(b, x, "bsr_spmm_grouped")
    if dev is None:
        return bsr_spmm_plain(b, x)
    out = _launch(b, x, dev, "bsr_spmm_grouped", "fitgnn_bsr_spmm_grouped",
                  _ARGS_FWD, [x])
    kernels.count(bsr_spmm_grouped, b.blocks)
    return out


def bsr_spmm_rowwalk(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """K10: ``A·x`` from zero on the row-walk layout, by the walk of each
    tile's non-zeros; a block row without tiles comes out zero."""
    if not b.rowwalk or b.einsum:
        raise ValueError("bsr_spmm_rowwalk: K10 walks the row-walk layout")
    if kernels.narrow("bsr_spmm_rowwalk", x):
        return kernels.widened(lambda x: bsr_spmm_rowwalk(b, x), x)
    dev = _operands(b, x, "bsr_spmm_rowwalk")
    if dev is None:
        return bsr_spmm_plain(b, x)
    out = _launch(b, x, dev, "bsr_spmm_rowwalk", "fitgnn_bsr_spmm_rowwalk",
                  _ARGS_FWD, [x])
    kernels.count(bsr_spmm_rowwalk, b.blocks)
    return out


for _fn in (bsr_spmm_acc, bsr_spmm_fwd, bsr_spmm_grouped, bsr_spmm_rowwalk):
    _fn.launches = _fn.launches_bf16 = 0
bsr_spmm_acc.launches_a = bsr_spmm_acc.launches_bfa = 0


def bsr_spmm_raw(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A·x`` by the layout, as the JAX package's ``_fwd_dispatch``: the
    einsum for the einsum layout, K10 for the row walk, K9 for ``group >
    1``, K2 otherwise.  No autograd."""
    if b.einsum:
        return bsr_spmm_einsum(b, x)
    if b.rowwalk:
        return bsr_spmm_rowwalk(b, x)
    if b.group > 1:
        return bsr_spmm_grouped(b, x)
    return bsr_spmm_fwd(b, x)


class _BsrSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, x):
        ctx.b = b
        return bsr_spmm_raw(b, x)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None
        return None, bsr_spmm_raw(ctx.b.transpose, g.contiguous())


def bsr_spmm(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A·x`` with ``A`` in BCSR form, (N_pad, F) → (N_pad, F),
    differentiable in ``x`` (the backward needs ``b.transpose``, built with
    the same layout flags)."""
    if b.transpose is None and x.requires_grad and torch.is_grad_enabled():
        raise ValueError("bsr_spmm: the gradient needs "
                         "build_bsr(with_transpose=True)")
    return _BsrSpmm.apply(b, x.contiguous())
