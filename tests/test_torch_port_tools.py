"""The JAX package's last tooling modules in the port, against the JAX
package on the CPU: ``data/synthetic.py``'s ``ring_graph`` and
``planted_products_graph`` (the same arrays from the same seed),
``build_hybrid``'s ``segmm_group`` (accepted, the same operator as the
JAX package's with the same group), ``coarsen/visualize.py``'s
``plot_coarsening`` (each level's scatter offsets and colours, the finest
level laid out by the port's copy of networkx's ``spring_layout``),
``utils/profiling.py`` (``Timer``, ``python_profile``, ``device_trace``)
and ``bench/roofline.py``'s ``measure_spmm_roofline`` at a small size.
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from fitgnn_tpu.bench.roofline import \
    measure_spmm_roofline as jax_measure_spmm_roofline
from fitgnn_tpu.coarsen.visualize import \
    plot_coarsening as jax_plot_coarsening
from fitgnn_tpu.data import synthetic as jax_synthetic
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.hybrid_spmm import hybrid_spmm as jax_hybrid_spmm

from fitgnn_tpu_torch.bench.roofline import (PEAK_HBM_GBPS,
                                             measure_spmm_roofline)
from fitgnn_tpu_torch.coarsen.visualize import plot_coarsening
from fitgnn_tpu_torch.data import synthetic
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid, hybrid_spmm
from fitgnn_tpu_torch.utils.profiling import (Timer, device_trace,
                                              python_profile)

from test_torch_port_bf16 import sorted_coo

torch.set_num_threads(1)


def same_arrays(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,seed", [(50, 0), (1000, 3)])
def test_ring_graph_matches_jax(n, seed):
    same_arrays(synthetic.ring_graph(n, seed=seed),
                jax_synthetic.ring_graph(n, seed=seed))


def test_planted_products_graph_matches_jax():
    """At 20,000 nodes (degree 25, 47 classes, 100 features)."""
    got = synthetic.planted_products_graph(20_000)
    same_arrays(got, jax_synthetic.planted_products_graph(20_000))
    assert got[1].shape[0] > 20_000 * 25 // 2 * 0.99


@pytest.mark.parametrize("group", [1, 2, "auto", None])
def test_segmm_group_builds_the_jax_operator(group):
    """``build_hybrid(use_segmm=True, segmm_group=g)``: the same straggler
    lists, tiles and product as the JAX package's with the same group."""
    s, r, w = sorted_coo(np.random.default_rng(4), 768, 6000)
    kw = dict(min_block_edges=30, use_segmm=True, segmm_group=group)
    ht = build_hybrid(s, r, w, 768, **kw)
    hj = jax_build_hybrid(s, r, w, 768, **kw)
    for name in ("senders", "receivers", "weights", "t_senders"):
        np.testing.assert_array_equal(getattr(ht, name).numpy(),
                                      np.asarray(getattr(hj, name)))
    np.testing.assert_array_equal(ht.bsr.blocks.numpy(),
                                  np.asarray(hj.bsr.blocks))
    x = np.random.default_rng(5).standard_normal((768, 16)).astype(
        np.float32)
    np.testing.assert_allclose(
        hybrid_spmm(ht, torch.from_numpy(x)).numpy(),
        np.asarray(jax_hybrid_spmm(hj, jnp.asarray(x))), rtol=1e-5,
        atol=1e-5)


def _scatters(fig):
    """Each axis's scatter: offsets, colours and title."""
    out = []
    for ax in fig.axes:
        cols = [c for c in ax.collections if len(c.get_offsets())]
        assert len(cols) == 1
        out.append((np.asarray(cols[0].get_offsets()),
                    np.asarray(cols[0].get_facecolors()), ax.get_title()))
    return out


@pytest.mark.parametrize("n", [60, 120])
def test_plot_coarsening_matches_jax(n):
    """Two levels on a community graph, the layout left to the function
    (networkx's ``spring_layout(seed=0)`` in the JAX package, the port's
    copy of it): every level's offsets, colours and title equal."""
    rng = np.random.default_rng(n)
    e = 4 * n
    r = rng.integers(0, n, e)
    s = np.where(rng.random(e) < 0.8, (r // 20) * 20 + rng.integers(0, 20, e),
                 rng.integers(0, n, e)) % n
    W = sp.csr_matrix((np.ones(e), (s, r)), shape=(n, n))
    W = W + W.T
    W.setdiag(0)
    W.eliminate_zeros()
    p0 = np.arange(n) // 2
    p1 = np.arange(n // 2) // 3
    got = _scatters(plot_coarsening(W, [p0, p1]))
    ref = _scatters(jax_plot_coarsening(W, [p0, p1]))
    assert len(got) == len(ref) == 3
    for (og, cg, tg), (orf, cr, tr) in zip(got, ref):
        np.testing.assert_array_equal(og, orf)
        np.testing.assert_array_equal(cg, cr)
        assert tg == tr


def test_plot_coarsening_given_coords_saves(tmp_path):
    W = sp.csr_matrix(np.ones((4, 4)) - np.eye(4))
    coords = np.arange(8, dtype=float).reshape(4, 2)
    path = tmp_path / "levels.png"
    fig = plot_coarsening(W, [np.array([0, 0, 1, 1])], coords=coords,
                          path=str(path))
    assert path.stat().st_size > 0
    np.testing.assert_array_equal(_scatters(fig)[0][0], coords)
    with pytest.raises(ValueError, match="small graphs"):
        plot_coarsening(W, [], max_nodes=3)


def test_timer_and_python_profile(capsys):
    with Timer("phase", verbose=True) as t:
        sum(range(10_000))
    assert t.elapsed > 0
    assert "[phase]" in capsys.readouterr().out
    out = []
    with python_profile(top=5, out=out):
        sorted(range(1000), key=lambda v: -v)
    assert len(out) == 1 and "function calls" in out[0]


def test_device_trace_on_the_cpu(tmp_path):
    """A Chrome trace of a small product, CPU activity only."""
    with device_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(ev.get("name", "")) for ev in events)
    assert prof.key_averages()


class _FakeProfile:
    """``torch.profiler.profile`` as it behaves on a card where CUPTI
    cannot trace: started and stopped, and its events those given."""

    def __init__(self, events, **kw):
        self._events = events
        self.activities = kw["activities"]

    def start(self):
        pass

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)

    def events(self):
        return self._events


@pytest.mark.parametrize("device_event", [False, True])
def test_device_trace_raises_without_device_events(monkeypatch, tmp_path,
                                                   device_event):
    """With a card present, a trace that holds no CUDA event raises (after
    it is written); one that holds a kernel does not."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    events = [SimpleNamespace(device_type=DeviceType.CPU)]
    if device_event:
        events.append(SimpleNamespace(device_type=DeviceType.CUDA))
    seen = []

    def fake(**kw):
        seen.append(_FakeProfile(events, **kw))
        return seen[-1]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", fake)
    if device_event:
        with device_trace(str(tmp_path)):
            pass
    else:
        with pytest.raises(RuntimeError, match="no CUDA event"):
            with device_trace(str(tmp_path)):
                pass
    assert torch.profiler.ProfilerActivity.CUDA in seen[0].activities
    assert (tmp_path / "trace.json").exists()


def test_measure_spmm_roofline_on_the_cpu():
    """The JAX package's model of the bytes on the same graph, timed on the
    CPU against the CPU entry of the peak table (no TPU row here)."""
    kw = dict(num_nodes=2048, avg_degree=4, feat=16, reps=2)
    got = measure_spmm_roofline(device="cpu", **kw)
    ref = jax_measure_spmm_roofline(**kw)
    assert got.bytes_moved == ref.bytes_moved
    assert got.peak_gbps == PEAK_HBM_GBPS["cpu"] == 50.0
    assert got.seconds_per_spmm > 0 and got.achieved_gbps > 0
    assert not any("tpu" in k for k in PEAK_HBM_GBPS)
    assert PEAK_HBM_GBPS["h100 80gb hbm3"] == 3350.0
