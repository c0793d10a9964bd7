"""The port's coarsening (``fitgnn_tpu_torch/coarsen/``) against the JAX
package's, on the CPU.

Both are host numpy/scipy, so the partitions must be equal and the
matrices equal within rtol 1e-10.  The port has no networkx: its maximal
cliques are held against networkx here (the sandbox has it), clique for
clique and in the same order.
"""

import networkx as nx
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fitgnn_tpu.coarsen import METHODS as JAX_METHODS
from fitgnn_tpu.coarsen import coarsen as jax_coarsen
from fitgnn_tpu.coarsen import quality as jax_quality
from fitgnn_tpu.coarsen.sparsify import graph_sparsify as jax_sparsify

from fitgnn_tpu_torch.coarsen import METHODS, coarsen, quality
from fitgnn_tpu_torch.coarsen import core, native_blossom, native_variation
from fitgnn_tpu_torch.coarsen.lapgraph import LapGraph
from fitgnn_tpu_torch.coarsen.matching import matching_optimal
from fitgnn_tpu_torch.coarsen.sparsify import graph_sparsify
from fitgnn_tpu_torch.coarsen.variation import maximal_cliques
from fitgnn_tpu_torch.utils.build import Target

torch.set_num_threads(1)


def community_w(n, deg=4, block=40, internal=0.8, seed=0):
    """A symmetric 0/1 adjacency with dense diagonal blocks."""
    rng = np.random.default_rng(seed)
    e = n * deg
    r = rng.integers(0, n, e)
    s = np.where(rng.random(e) < internal,
                 np.minimum((r // block) * block + rng.integers(0, block, e),
                            n - 1), rng.integers(0, n, e))
    W = sp.csr_matrix((np.ones(e), (s, r)), shape=(n, n))
    W = W + W.T
    W.data[:] = 1.0
    W.setdiag(0)
    W.eliminate_zeros()
    return W


def assert_same(a, b):
    np.testing.assert_array_equal(a.parent, b.parent)
    assert a.num_levels == b.num_levels
    for ma, mb in ((a.C, b.C), (a.Wc, b.Wc)):
        assert ma.shape == mb.shape
        np.testing.assert_allclose(ma.toarray(), mb.toarray(), rtol=1e-10,
                                   atol=0)


def test_methods_are_the_jax_packages():
    assert METHODS == JAX_METHODS and len(METHODS) == 14


@pytest.mark.parametrize("method", METHODS)
def test_coarsen_matches_jax(method):
    W = community_w(220, seed=1)
    got = coarsen(W, r=0.5, method=method, K=8)
    ref = jax_coarsen(W, r=0.5, method=method, K=8)
    assert_same(got, ref)
    assert got.num_coarse < 220


def test_native_variation_branch_matches_jax():
    """Above 3,000 nodes variation_neighborhoods takes the C++ core."""
    W = community_w(3_200, deg=3, block=64, seed=2)
    assert W.shape[0] > core.NATIVE_VARIATION_MIN_NODES
    got = coarsen(W, r=0.5, method="variation_neighborhoods", K=6)
    ref = jax_coarsen(W, r=0.5, method="variation_neighborhoods", K=6)
    assert_same(got, ref)
    assert got.num_coarse <= 0.55 * W.shape[0]


@pytest.mark.parametrize("method", ["heavy_edge", "variation_edges",
                                    "algebraic_JC"])
def test_optimal_matching_runs_the_native_blossom(method):
    W = community_w(160, seed=3)
    got = coarsen(W, r=0.4, method=method, K=8, algorithm="optimal")
    ref = jax_coarsen(W, r=0.4, method=method, K=8, algorithm="optimal")
    assert_same(got, ref)


def test_optimal_matching_refuses_more_nodes_than_the_blossom_holds():
    n = native_blossom.MAX_NODES + 1
    edges = np.stack([np.arange(n - 1), np.arange(1, n)])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        matching_optimal(n, edges, np.ones(n - 1), 0.3)


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No fallback to the Python loop: a core that does not build
    raises."""
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    broken = Target("variation_broken_for_test", [str(src)], lambda out: [
        "g++", "-shared", "-fPIC", str(src), "-o", out])
    monkeypatch.setattr(native_variation, "VARIATION", broken)
    monkeypatch.setattr(native_variation, "_lib_handle", None)
    W = community_w(3_100, deg=3, block=64, seed=4)
    with pytest.raises(RuntimeError, match="native build failed"):
        coarsen(W, r=0.5, method="variation_neighborhoods", K=4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maximal_cliques_match_networkx(seed):
    rng = np.random.default_rng(seed)
    n = 120 + 40 * seed
    W = community_w(n, deg=5, block=12, seed=seed)
    if seed == 1:
        W = LapGraph(W).W                 # the graph variation_cliques sees
    if seed == 2:                         # unsorted CSR rows and self loops
        W = sp.csr_matrix(W + sp.eye(n))
        W.indices = W.indices.copy()
        for i in range(n):
            a, b = W.indptr[i], W.indptr[i + 1]
            p = rng.permutation(b - a)
            W.indices[a:b] = W.indices[a:b][p]
            W.data[a:b] = W.data[a:b][p]
        W.has_sorted_indices = False
    got = maximal_cliques(W)
    ref = list(nx.find_cliques(nx.from_scipy_sparse_array(W)))
    assert got == ref
    assert {frozenset(c) for c in got} == {frozenset(c) for c in ref}


def test_quality_oracles_match_jax():
    W = community_w(150, seed=5)
    res = coarsen(W, r=0.5, method="variation_neighborhoods", K=8)
    for name in ("eigenvalue_errors", "subspace_angles"):
        np.testing.assert_allclose(
            getattr(quality, name)(W, res.C, kmax=8),
            getattr(jax_quality, name)(W, res.C, kmax=8),
            rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        quality.rayleigh_preservation(W, res.C, res.Wc, kmax=8),
        jax_quality.rayleigh_preservation(W, res.C, res.Wc, kmax=8),
        rtol=1e-8, atol=1e-10)
    assert quality.eigenvalue_errors(W, res.C, kmax=8)[:3].max() < 1.0


def test_sparsify_matches_jax():
    W = community_w(200, deg=8, seed=6)
    got, ref = graph_sparsify(W, epsilon=0.5, seed=1), jax_sparsify(
        W, epsilon=0.5, seed=1)
    np.testing.assert_allclose(got.toarray(), ref.toarray(), rtol=1e-10)
