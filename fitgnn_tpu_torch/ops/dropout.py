"""Fused dropout with a counter-based mask (K11).

``fused_dropout(x, seed, rate)`` is inverted dropout whose mask is made
inside the kernel from a counter-based generator, as the JAX package's
``fused_dropout`` makes it from the TPU core's PRNG: one pass over the
tensor, no mask in device memory, and a backward that regenerates the same
mask from the same seed and applies it to the incoming gradient.

The rule is the JAX kernel's: ``keep = bits >= uint32(int(rate·2³²))``,
``out = where(keep, x·scale, 0)`` with ``scale = float32(1/(1−rate))``,
multiplied, not divided.  The bits are Philox4x32-10 keyed by
``(seed, 0)``: element ``i`` of the flattened tensor takes word ``i % 4`` of
the Philox block at the 64-bit counter ``i // 4``.  The stream differs from
the TPU's (dropout needs i.i.d. Bernoulli noise, not a particular stream).

* On a CUDA tensor ``philox_dropout`` launches the hand-written kernel
  ``csrc/dropout.cu`` (it replaces the TPU kernel
  ``fitgnn_tpu/ops/pallas/dropout.py:_kernel``; the source note there says
  what bounds it on an H100 and what the design does about it).  The seed
  stays in device memory: no host sync on the step.
* On a CPU tensor it runs the plain version ``philox_dropout_plain``: the
  same Philox rounds in int64 torch arithmetic, bit for bit the kernel's.

``philox_dropout.launches`` counts kernel launches (one per forward and one
per backward).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fitgnn_tpu_torch.ops import kernels

_M32 = 0xFFFFFFFF
_MUL = (0xD2511F53, 0xCD9E8D57)       # Philox4x32 round multipliers
_WEYL = (0x9E3779B9, 0xBB67AE85)      # Philox4x32 key increments


def _mulhilo(m: int, c: torch.Tensor) -> tuple:
    """(hi, lo) 32-bit halves of ``m · c`` for a 32-bit constant ``m`` and
    int64 tensor ``c`` holding uint32 values.  The full product overflows
    int64, so ``m`` is split into 16-bit halves (each partial < 2⁴⁸)."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    p_lo = m_lo * c
    p_hi = m_hi * c
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _M32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32(counter: tuple, key: tuple) -> tuple:
    """Philox4x32-10 on int64 tensors holding uint32 words: ``counter`` is
    four broadcastable tensors, ``key`` two; returns the four output
    words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _WEYL[0]) & _M32
            k1 = (k1 + _WEYL[1]) & _M32
        hi0, lo0 = _mulhilo(_MUL[0], c0)
        hi1, lo1 = _mulhilo(_MUL[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(seed: torch.Tensor, numel: int) -> torch.Tensor:
    """The kernel's (numel,) uint32 words, as int64: word ``i % 4`` of the
    Philox block at counter ``i // 4``, key ``(seed, 0)``."""
    blocks = -(-numel // 4)
    idx = torch.arange(blocks, dtype=torch.int64, device=seed.device)
    zero = torch.zeros((), dtype=torch.int64, device=seed.device)
    key0 = seed.reshape(()).to(torch.int64) & _M32
    words = philox4x32((idx & _M32, idx >> 32, zero, zero), (key0, zero))
    return torch.stack(words, dim=1).reshape(-1)[:numel]


def _threshold(rate: float) -> tuple:
    """(uint32 threshold, float32 scale) of the JAX kernel's rule."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_dropout: rate must be in [0, 1), got {rate}")
    return int(rate * 2 ** 32), float(np.float32(1.0 / (1.0 - rate)))


def philox_dropout_plain(x: torch.Tensor, seed: torch.Tensor,
                         rate: float) -> torch.Tensor:
    """Plain PyTorch K11: the kernel's bits, keep rule and scale."""
    thresh, scale = _threshold(rate)
    keep = dropout_bits(seed, x.numel()).reshape(x.shape) >= thresh
    return torch.where(keep, x * torch.tensor(scale, dtype=x.dtype,
                                              device=x.device), 0.0)


# x, out, seed, numel, threshold, scale, vec, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_uint32,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]


def philox_dropout(x: torch.Tensor, seed: torch.Tensor,
                   rate: float) -> torch.Tensor:
    """``where(keep, x·scale, 0)`` with the Philox mask of ``seed`` (a
    one-element int32 tensor on ``x``'s device): the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor.  No autograd: see
    ``fused_dropout``."""
    if seed.numel() != 1 or seed.dtype != torch.int32:
        raise ValueError("philox_dropout: seed must be a one-element int32 "
                         f"tensor, got {seed.dtype} {tuple(seed.shape)}")
    if x.device.type == "cpu":
        return philox_dropout_plain(x, seed, rate)
    if x.device.type != "cuda":
        raise ValueError(f"philox_dropout: unsupported device {x.device}")
    thresh, scale = _threshold(rate)
    dev = x.device
    kernels.require(x, "x", torch.float32, dev)
    kernels.require(seed, "seed", torch.int32, dev)
    out = torch.empty_like(x)
    launch = kernels.function("dropout", "fitgnn_philox_dropout", _ARGTYPES)
    vec = int(x.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(x), kernels.ptr(out), kernels.ptr(seed),
                    x.numel(), thresh, scale, vec, kernels.stream(dev))
    kernels.check(rc, "philox_dropout")
    philox_dropout.launches += 1
    return out


philox_dropout.launches = 0


class _FusedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.save_for_backward(seed)
        ctx.rate = rate
        return philox_dropout(x.contiguous(), seed, rate)

    @staticmethod
    def backward(ctx, g):
        # dropout is linear in x given the mask: the same seed regenerates
        # the same mask, applied to g
        (seed,) = ctx.saved_tensors
        return philox_dropout(g.contiguous(), seed, ctx.rate), None, None


def fused_dropout(x: torch.Tensor, seed: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """Dropped-out ``x``, differentiable in ``x``; ``seed`` is a (1,) int32
    tensor on ``x``'s device (``seed_from_generator``)."""
    return _FusedDropout.apply(x, seed, rate)


def seed_from_generator(generator: torch.Generator,
                        device: torch.device) -> torch.Tensor:
    """A (1,) int32 kernel seed drawn from ``generator`` on ``device``
    without a host sync (the JAX package's ``seed_from_rng``: one draw in
    [0, 2³¹−1))."""
    return torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int32,
                         device=device, generator=generator)
