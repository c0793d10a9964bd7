"""SpMM memory-roofline reporter: the JAX package's ``measure_spmm_roofline``
on the card.

Model: a COO SpMM over E edges with F float32 features moves at least
``E·F·4`` bytes of gathered rows + ``N·F·4`` bytes of output + ``E·12``
bytes of indices and weights; the roofline time is that traffic at the
device's peak memory rate.  The function is the JAX package's per-edge
segment sum, ``out[r] += w·x[s]`` (``index_select`` + ``index_add_``,
plain PyTorch as the JAX package's is XLA), carried ``reps`` times through
a loop that feeds each output into the next call, and timed on the card
with CUDA events (wall clock on the CPU).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

# peak memory rate per device, GB/s: the H100 SXM's HBM3 (NVIDIA data
# sheet) and the JAX package's CPU figure
PEAK_HBM_GBPS = {
    "h100 80gb hbm3": 3350.0,
    "cpu": 50.0,
}


def detect_peak_gbps(device) -> float:
    """The peak of ``device`` from ``PEAK_HBM_GBPS``, by its name."""
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device).lower()
        for key, bw in PEAK_HBM_GBPS.items():
            if key in name:
                return bw
        raise ValueError(f"no peak memory rate for {name!r} in "
                         "PEAK_HBM_GBPS")
    return PEAK_HBM_GBPS["cpu"]


@dataclasses.dataclass
class RooflineReport:
    seconds_per_spmm: float
    bytes_moved: float
    achieved_gbps: float
    peak_gbps: float

    @property
    def fraction_of_roofline(self) -> float:
        return self.achieved_gbps / self.peak_gbps


def measure_spmm_roofline(num_nodes: int = 131_072, avg_degree: int = 8,
                          feat: int = 512, reps: int = 20, seed: int = 0,
                          device="cuda") -> RooflineReport:
    """Times the per-edge segment sum on ``device`` (the card unless the
    caller asks for the CPU) on the JAX package's random graph of the same
    seed, sizes and draws."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    e = num_nodes * avg_degree
    senders = torch.from_numpy(
        rng.integers(0, num_nodes, e, dtype=np.int32)).to(device)
    receivers = torch.from_numpy(
        np.sort(rng.integers(0, num_nodes, e, dtype=np.int32))).to(device)
    w = torch.from_numpy(rng.random(e).astype(np.float32) * 0.1).to(device)
    x = torch.from_numpy(rng.standard_normal(
        (num_nodes, feat)).astype(np.float32)).to(device)
    s_long, r_long = senders.long(), receivers.long()

    def loop(xc):
        for _ in range(reps):
            out = torch.zeros_like(xc).index_add_(
                0, r_long, xc.index_select(0, s_long) * w[:, None])
            xc = out * 0.35
        return xc

    # the warm-up's output feeds the timed loop, as in the JAX package
    with torch.inference_mode():
        warm = loop(x)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            loop(warm)
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3 / reps
        else:
            t0 = time.perf_counter()
            loop(warm)
            sec = (time.perf_counter() - t0) / reps

    bytes_moved = (e * feat * 4.0            # gathered rows
                   + num_nodes * feat * 4.0  # scattered output
                   + e * (4 + 4 + 4.0))      # indices + weights
    achieved = bytes_moved / sec / 1e9
    return RooflineReport(seconds_per_spmm=sec, bytes_moved=bytes_moved,
                          achieved_gbps=achieved,
                          peak_gbps=detect_peak_gbps(device))
