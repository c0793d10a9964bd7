"""Profiling and tracing helpers: the JAX package's ``Timer``,
``python_profile`` and ``device_trace``, the last on ``torch.profiler``.

``device_trace(logdir)`` records the block into a Chrome trace
(``logdir/trace.json``, open in Perfetto or chrome://tracing), with the
card's kernels (CUDA activity) when a card is present.  On the card a
trace that does not start raises, and so does one that holds no device
event (``torch.profiler`` only warns when CUPTI cannot trace the card and
then records the host alone): the JAX package's silent no-op would leave
a measurement without its trace.  A block traced on the card must
therefore run something there.
"""

from __future__ import annotations

import contextlib
import cProfile
import io
import os
import pstats
import time
from typing import Iterator, Optional

import torch


class Timer:
    """``with Timer("phase") as t: ...`` → t.elapsed seconds."""

    def __init__(self, name: str = "", verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"[{self.name}] {self.elapsed:.4f}s")


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Trace the block with ``torch.profiler`` and write ``logdir/trace.json``
    (Chrome trace format), the card's activity included when a card is
    present.  Yields the profiler, whose ``key_averages()`` the caller may
    read after the block.  On the card, raises ``RuntimeError`` when the
    trace holds no device event (the trace is written first)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()            # on the card a failure to start raises
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    if cuda and not device_events(prof):
        raise RuntimeError(
            "device_trace: the trace holds no CUDA event; torch.profiler "
            "could not trace the card (CUPTI), or the block ran nothing on "
            "it")


def device_events(prof) -> int:
    """The device (kernel and copy) events of a stopped profiler."""
    from torch.autograd import DeviceType
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


@contextlib.contextmanager
def python_profile(sort: str = "cumulative", top: int = 30,
                   out: Optional[list] = None) -> Iterator[None]:
    """cProfile a host-side block; prints (or appends to ``out``) the top
    entries."""
    pr = cProfile.Profile()
    pr.enable()
    try:
        yield
    finally:
        pr.disable()
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats(sort).print_stats(top)
        if out is not None:
            out.append(s.getvalue())
        else:
            print(s.getvalue())
