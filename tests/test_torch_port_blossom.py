"""Optimal matching above the native blossom's size
(``fitgnn_tpu_torch/coarsen/blossom.py``) against networkx and the JAX
package, on the CPU.

The port's copy of networkx's ``max_weight_matching`` must give networkx's
exact ``mate`` (``maxcardinality=True``) on the graph the JAX package
builds: nodes first, then the edges in input order, a repeated pair
keeping the last weight.  The graphs here are seeded, of 2 to 200 nodes,
some with repeated pairs in either direction and some with tied integer
weights, where several matchings weigh the same and the order decides.
Then ``coarsen(algorithm="optimal")`` above ``MAX_NODES`` against the JAX
package: ``MAX_NODES`` is lowered for the test and the JAX package's
native core made to decline, so both take their pure-Python path on a
~150-node graph (networkx is too slow at the real threshold for a test).
"""

import networkx as nx
import numpy as np
import pytest
import torch

import fitgnn_tpu.coarsen.native_blossom as jax_native_blossom
from fitgnn_tpu.coarsen import coarsen as jax_coarsen

from fitgnn_tpu_torch.coarsen import blossom, coarsen, native_blossom
from fitgnn_tpu_torch.coarsen.matching import matching_optimal

from test_torch_port_coarsen import assert_same, community_w

torch.set_num_threads(1)


def nx_mate(edges, weights, n):
    """networkx's matching of the JAX package's graph, as a mate array."""
    g = nx.Graph()
    g.add_nodes_from(range(n))
    for (a, b), w in zip(edges.T, weights):
        g.add_edge(int(a), int(b), weight=float(w))
    mate = np.full(n, -1, dtype=np.int64)
    for a, b in nx.max_weight_matching(g, maxcardinality=True):
        mate[a], mate[b] = b, a
    return mate


def seeded_graph(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 201))
    e = rng.integers(0, n, (2, int(rng.integers(1, 4 * n))))
    e = e[:, e[0] != e[1]]
    if seed % 3 == 0:
        # repeated pairs, some reversed, with other weights
        k = e.shape[1] // 3
        e = np.concatenate([e, e[::-1, :k], e[:, k:2 * k]], axis=1)
    if seed % 2:
        w = rng.integers(1, 4, e.shape[1]).astype(np.float64)   # ties
    else:
        w = rng.random(e.shape[1])
    return e, w, n


@pytest.mark.parametrize("seed", range(24))
def test_matching_equals_networkx(seed):
    e, w, n = seeded_graph(seed)
    got = blossom.max_weight_matching(e, w, n, max_cardinality=True)
    np.testing.assert_array_equal(got, nx_mate(e, w, n))


def test_repeated_pair_keeps_its_first_position_and_last_weight():
    """A pair given twice keeps the second weight and the neighbour
    position of its first insertion, as ``add_edge`` leaves them."""
    g = blossom._Graph(4, np.array([[0, 0, 2, 1], [1, 2, 3, 0]]),
                       np.array([1.0, 2.0, 3.0, 5.0]))
    assert list(g.neighbors(0)) == [1, 2]
    assert g[0][1]["weight"] == g[1][0]["weight"] == 5.0
    assert [(u, v) for u, v, _ in g.edges()] == [(0, 1), (0, 2), (2, 3)]


def test_empty_and_edgeless_graphs():
    none = np.zeros((2, 0), dtype=np.int64)
    assert blossom.max_weight_matching(none, np.zeros(0), 0).shape == (0,)
    np.testing.assert_array_equal(
        blossom.max_weight_matching(none, np.zeros(0), 3), [-1, -1, -1])


@pytest.mark.parametrize("method", ["heavy_edge", "algebraic_JC"])
def test_coarsen_optimal_above_max_nodes_matches_jax(monkeypatch, method):
    """``coarsen(algorithm="optimal")`` on a 150-node graph with
    ``MAX_NODES`` lowered to 64: the port's blossom against networkx in
    the JAX package; the partitions and matrices equal."""
    monkeypatch.setattr(native_blossom, "MAX_NODES", 64)
    monkeypatch.setattr(jax_native_blossom, "max_weight_matching_native",
                        lambda *a, **k: None)

    def refuse(*a, **k):
        raise AssertionError("the native core took an instance above "
                             "MAX_NODES")

    monkeypatch.setattr(native_blossom, "max_weight_matching_native",
                        refuse)
    W = community_w(150, seed=5)
    got = coarsen(W, r=0.4, method=method, K=8, algorithm="optimal")
    ref = jax_coarsen(W, r=0.4, method=method, K=8, algorithm="optimal")
    assert_same(got, ref)


def test_matching_optimal_dispatches_by_size(monkeypatch):
    """At ``MAX_NODES`` the native core, one node above it the port's
    blossom."""
    used = []
    monkeypatch.setattr(native_blossom, "MAX_NODES", 10)
    orig_py, orig_nat = (blossom.max_weight_matching,
                         native_blossom.max_weight_matching_native)
    monkeypatch.setattr(blossom, "max_weight_matching",
                        lambda *a, **k: used.append("py") or orig_py(*a, **k))
    monkeypatch.setattr(native_blossom, "max_weight_matching_native",
                        lambda *a, **k: used.append("native")
                        or orig_nat(*a, **k))
    for n in (10, 11):
        edges = np.stack([np.arange(n - 1), np.arange(1, n)])
        matching_optimal(n, edges, np.ones(n - 1), 0.3)
    assert used == ["native", "py"]
    with pytest.raises(ValueError, match="at most 10"):
        orig_nat(edges, np.ones(10), 11)
