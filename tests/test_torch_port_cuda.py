"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels build at
first use) and skips without one; ``chip_smoke.py`` runs the same checks on
the card at the bench graph's shapes.  Tolerance: rtol 1e-4 and atol
1e-4·max|ref|, f32 sums taken in another order.
"""

import numpy as np
import pytest
import torch

from fitgnn_tpu_torch.ops.bsr_spmm import (build_bsr, bsr_spmm_acc,
                                           bsr_spmm_acc_plain)
from fitgnn_tpu_torch.ops.coo_segmm import (build_segmm, segmm_spmm,
                                            segmm_spmm_plain)
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid, hybrid_spmm

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


# F=101 (F % 4 != 0) and the unaligned view take the kernel's scalar branch;
# the others its 16-byte vector branch
@pytest.mark.parametrize("feat,aligned", [(16, True), (100, True),
                                          (101, True), (128, True),
                                          (512, True), (128, False)])
def test_k3_kernel_matches_plain(cuda, feat, aligned):
    rng = np.random.default_rng(feat + 1)
    n = 1024
    s, r, w = _coo(rng, n, 3_000, internal=0.0)
    keep = (r // 128) != 3          # an empty block: rows written as 0
    m = build_segmm(s[keep], r[keep], w[keep], n).to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, feat)).astype(np.float32))
    xd = x.to(cuda) if aligned else _unaligned(x.to(cuda))
    before = segmm_spmm.launches
    with torch.inference_mode():
        got = segmm_spmm(m, xd)
        ref = segmm_spmm_plain(m, xd)
    torch.cuda.synchronize()
    assert segmm_spmm.launches == before + 1
    _close(got, ref)
    assert not got[3 * 128:4 * 128].any()


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


def test_kernel_rejects_grad(cuda):
    m = build_segmm(np.array([0]), np.array([0]), np.ones(1, np.float32),
                    128).to(cuda)
    x = torch.zeros((128, 4), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        segmm_spmm(m, x)
