"""The C++ ingest branch of ``build_graph`` (``graph/native_build.py``,
``native/graphbuild.cpp``) against the JAX package's, on the CPU.

Above 2,000,000 unweighted edges both packages' ``build_graph`` take the
one-pass C++ core, whose edges come sorted by receiver then sender (the
numpy branch's order is a stable sort on the receiver alone), so the
port's senders, receivers and weights must equal the JAX package's
exactly, in order, and so must the padded ``Graph``.  The binding is held
against ``build_edges_native`` in its directed, no-self-loop and
no-normalise modes; a weighted input of the same size stays on the numpy
branch in both packages.

The JAX package builds its library in place at first use with no lock
(``fitgnn_tpu/graph/native_build.py``), and ``tests/test_native_build.py``
may build it at the same moment in another process.  So the reference
side here builds its own copy into a private temporary directory (the
module's paths patched for the test, no file of the JAX package touched),
where no other process writes, and it must load.
"""

import os

import numpy as np
import pytest
import torch

import fitgnn_tpu.graph.native_build as jax_native_build
from fitgnn_tpu.graph.build import build_graph as jax_build_graph

from fitgnn_tpu_torch.graph import build as build_mod
from fitgnn_tpu_torch.graph import native_build
from fitgnn_tpu_torch.graph.build import build_graph

torch.set_num_threads(1)

N = 100_000
M = 2_050_000          # directed input edges: above the 2,000,000 branch


@pytest.fixture(scope="module")
def jax_core_dir(tmp_path_factory):
    """The JAX package's ingest core, built once by its own ``_lib`` into a
    private directory."""
    d = tmp_path_factory.mktemp("jax_graphbuild")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_build, "_SO_DIR", str(d))
        mp.setattr(jax_native_build, "_SO", str(d / "libgraphbuild.so"))
        mp.setattr(jax_native_build, "_lib_handle", None)
        jax_native_build._lib()
    assert os.path.exists(d / "libgraphbuild.so")
    return d


@pytest.fixture
def jax_core(monkeypatch, jax_core_dir):
    """The JAX package's module reading its private copy of the core."""
    monkeypatch.setattr(jax_native_build, "_SO_DIR", str(jax_core_dir))
    monkeypatch.setattr(jax_native_build, "_SO",
                        str(jax_core_dir / "libgraphbuild.so"))
    monkeypatch.setattr(jax_native_build, "_lib_handle", None)


def big_input(seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N, M).astype(np.int32)
    r = ((s + rng.integers(1, 2000, M)) % N).astype(np.int32)
    return s, r


def test_build_graph_takes_the_native_branch_as_jax(jax_core, monkeypatch):
    """2,050,000 unweighted edges on 100,000 nodes: both take the C++
    branch (the port's counted), and every array of the padded graph is
    the JAX package's, exactly."""
    s, r = big_input()
    x = np.zeros((N, 1), np.float32)
    calls = []
    orig = build_mod.build_edges_native

    def counted(*a, **k):
        calls.append(len(a[0]))
        return orig(*a, **k)

    monkeypatch.setattr(build_mod, "build_edges_native", counted)
    gt = build_graph(x, s, r)
    gj = jax_build_graph(x, s, r)
    assert calls == [M]
    assert int(gt.n_edge) == int(gj.n_edge)
    for name in ("senders", "receivers", "edge_weight", "x"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gj, name)),
                                      err_msg=name)
    n_e = int(gt.n_edge)
    sr = gt.receivers.numpy()[:n_e]
    assert (np.diff(sr) >= 0).all()
    # sorted by receiver then sender: not the numpy branch's order
    same_r = sr[1:] == sr[:-1]
    assert (np.diff(gt.senders.numpy()[:n_e])[same_r] > 0).all()


@pytest.mark.parametrize("mode", [
    dict(), dict(undirected=False), dict(self_loops=False),
    dict(normalize=False),
    dict(undirected=False, self_loops=False, normalize=False)])
def test_binding_matches_jax(jax_core, mode):
    """``build_edges_native`` of both packages on a small input, each mode:
    the same senders, receivers and weights, exactly."""
    rng = np.random.default_rng(3)
    s = rng.integers(0, 300, 3000)
    r = rng.integers(0, 300, 3000)
    keep = s != r
    got = native_build.build_edges_native(s[keep], r[keep], 300, **mode)
    ref = jax_native_build.build_edges_native(s[keep], r[keep], 300, **mode)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_weighted_input_stays_on_the_numpy_branch(jax_core, monkeypatch):
    """The same size with weights other than 1: the numpy branch in both
    (the port's core never called), the same arrays."""
    s, r = big_input(seed=1)
    w = np.random.default_rng(2).random(M).astype(np.float32) + 0.5

    def refuse(*a, **k):
        raise AssertionError("the native branch took a weighted input")

    monkeypatch.setattr(build_mod, "build_edges_native", refuse)
    monkeypatch.setattr(jax_native_build, "build_edges_native", refuse)
    x = np.zeros((N, 1), np.float32)
    gt = build_graph(x, s, r, edge_weight=w)
    gj = jax_build_graph(x, s, r, edge_weight=w)
    for name in ("senders", "receivers", "edge_weight"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gj, name)),
                                      err_msg=name)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback to the numpy branch: a core that does not build
    raises."""
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    broken = native_build.Target(
        "graphbuild_broken_for_test", [str(src)],
        lambda out: ["g++", "-shared", "-fPIC", str(src), "-o", out])
    monkeypatch.setattr(native_build, "GRAPHBUILD", broken)
    monkeypatch.setattr(native_build, "_lib_handle", None)
    s, r = big_input()
    with pytest.raises(RuntimeError, match="native build failed"):
        build_graph(np.zeros((N, 1), np.float32), s, r)
