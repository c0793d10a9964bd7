"""The port's GCN ``NodeModel`` eval forward against the JAX package's, with
the JAX parameters converted by ``params_from_flax``, on graphs with and
without the hybrid operator attached (each package building its own through
``build_optimized_graph``).  Log-probs within atol 1e-5: the dense layers and
sums run in another order.
"""

import numpy as np
import pytest
import torch

import jax

from fitgnn_tpu.graph.build import build_graph as jax_build_graph
from fitgnn_tpu.graph.optimize import \
    build_optimized_graph as jax_build_optimized_graph
from fitgnn_tpu.models import NodeModel as JaxNodeModel

from fitgnn_tpu_torch.graph.build import build_graph
from fitgnn_tpu_torch.graph.optimize import (AUTO_MIN_NODES,
                                             build_optimized_graph,
                                             should_use_hybrid)
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.ops.hybrid_spmm import HybridSpmm

torch.set_num_threads(1)


def community_graph(rng, n, feat, deg=10, block=128, internal=0.85):
    e = n * deg
    r = rng.integers(0, n, e)
    s_in = np.minimum((r // block) * block + rng.integers(0, block, e), n - 1)
    s = np.where(rng.random(e) < internal, s_in, rng.integers(0, n, e))
    keep = s != r
    perm = rng.permutation(n)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    return x, perm[s[keep]], perm[r[keep]]


def port_model(params, in_dim, hidden, layers, out_dim, classify=True):
    m = NodeModel("GCNConv", in_dim, hidden, layers, out_dim,
                  classify=classify)
    m.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    return m.eval()


@pytest.mark.parametrize("hybrid", [True, False])
@pytest.mark.parametrize("n,feat,hidden,threshold", [(300, 16, 32, 200),
                                                     (900, 16, 32, 48),
                                                     (900, 128, 64, 48)])
def test_node_model_matches_jax(hybrid, n, feat, hidden, threshold):
    rng = np.random.default_rng(n + feat)
    x, s, r = community_graph(rng, n, feat)
    if hybrid:
        gt, ot = build_optimized_graph(x, s, r, min_block_edges=threshold)
        gj, oj = jax_build_optimized_graph(x, s, r,
                                           min_block_edges=threshold)
        np.testing.assert_array_equal(ot, oj)
        assert isinstance(gt.aux, HybridSpmm) and gt.aux.bsr is not None
        assert gt.aux.num_coo_edges > 1
    else:
        gt, gj = build_graph(x, s, r), jax_build_graph(x, s, r)
    jm = JaxNodeModel(layer_name="GCNConv", hidden=hidden, num_layers=2,
                      out_dim=5)
    params = jm.init(jax.random.PRNGKey(0), gj.x, gj)
    ref = np.asarray(jm.apply(params, gj.x, gj))
    with torch.inference_mode():
        out = port_model(params, feat, hidden, 2, 5)(gt.x, gt).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_regression_head_matches_jax():
    rng = np.random.default_rng(2)
    x, s, r = community_graph(rng, 200, 8)
    gt, gj = build_graph(x, s, r), jax_build_graph(x, s, r)
    jm = JaxNodeModel(layer_name="GCNConv", hidden=16, num_layers=1,
                      out_dim=1, classify=False)
    params = jm.init(jax.random.PRNGKey(1), gj.x, gj)
    with torch.inference_mode():
        out = port_model(params, 8, 16, 1, 1, classify=False)(gt.x, gt)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jm.apply(params, gj.x, gj)),
                               atol=1e-5, rtol=0)


def test_random_init_follows_flax_scale():
    """Seeded init: lecun_normal kernels (std ≈ 1/sqrt(fan_in), truncated
    at ±2σ), zero biases; the same seed gives the same weights."""
    a = NodeModel("GCNConv", 256, 512, 2, 40).reset_parameters(
        torch.Generator().manual_seed(0))
    b = NodeModel("GCNConv", 256, 512, 2, 40).reset_parameters(
        torch.Generator().manual_seed(0))
    for (ka, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), ka
    w = a.convs.layers[0].lin.weight.detach()
    assert abs(float(w.std()) - (1 / 256) ** 0.5) < 0.003
    assert float(w.abs().max()) <= 2 * (1 / 256) ** 0.5 / 0.8796 + 1e-6
    assert not a.convs.layers[0].bias.any() and not a.head.bias.any()


def test_hybrid_gate():
    assert should_use_hybrid(AUTO_MIN_NODES, "GCNConv")
    assert not should_use_hybrid(AUTO_MIN_NODES - 1, "GCNConv")
    assert not should_use_hybrid(10 ** 6, "MLP")


def test_unknown_layer_raises():
    """As the JAX package's ``make_layer``: a ValueError naming the four
    layers."""
    with pytest.raises(ValueError, match="GINConv"):
        NodeModel("MLP", 8, 16, 2, 3)
