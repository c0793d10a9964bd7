"""The conv stack's bf16 compute dtype against the JAX package, on the CPU.

``NodeModel(dtype=torch.bfloat16)`` against the JAX
``NodeModel(dtype=jnp.bfloat16)`` with the JAX model's weights carried
across by ``params_from_flax``: GCN, SAGE and GIN on the hybrid operator of
``build_optimized_graph`` with f32 and bf16 tiles, and a pre-aggregated
GCN on bf16 tiles (``bench.py``'s stack); GAT in
``tests/test_torch_port_bf16_model_gat.py`` through ``check_case`` here.
The JAX Pallas kernels run in interpret mode; the port's wrappers take
their plain versions because the tensors lie on the CPU.

Held, dropout off: the eval log-probs within ``2e-2·max(1, max|ref|)``;
one ``gc_train_step``'s loss within 1e-2 relative and each parameter's
gradient within ``5e-2·max|ref|`` of that leaf.  Both sides compute in
bf16 (8 bits of mantissa, a relative step of 2⁻⁸ ≈ 4e-3 a rounding) but
round in different places: the Pallas kernels round each tile's or
chunk's partial into a bf16 block, the port's kernels round each sum
once, and a few layers (GIN's sums, the stack of two) compound such
differences.  A forward hook asserts that every conv layer's output is
bf16, so a port that computed in f32 fails even where it would agree.

One leaf is held otherwise: GAT's ``att_dst``.  Its gradient sums the
softmax's ``⟨g_i, x_j⟩ − ⟨g_i, out_i⟩`` over every edge, a difference of
near-equal bf16 terms, and each package's bf16 gradient lies 3-8% of its
largest entry from the same model's f32 gradient (measured at this size:
the JAX package's 5.2-8.1%, the port's 3.4-6.7%), so the two lie up to
the sum apart.  It is held against the f32 gradient (the port's f32
model, which the f32 tests hold to the JAX package's within 1e-5): the
port's distance at most 1.5 times the JAX package's bf16 distance, and
within 1e-1 of its largest entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fitgnn_tpu.ops.tile_gat as jax_tile_gat_mod
from fitgnn_tpu.graph.optimize import \
    _operator_weights as jax_operator_weights
from fitgnn_tpu.graph.optimize import \
    build_optimized_graph as jax_build_optimized_graph
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.models.models import \
    preaggregate_input as jax_preaggregate_input
from fitgnn_tpu.train import losses as jax_losses

from fitgnn_tpu_torch.graph.optimize import (_LAYER_SEMANTICS,
                                             _operator_weights,
                                             build_optimized_graph)
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import NodeModel, preaggregate_input
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
from fitgnn_tpu_torch.train import steps

from test_torch_port_sage_gin import community_graph

torch.set_num_threads(1)

BF16 = torch.bfloat16
N = 384

# case: (layer, tiles in bf16, pre-aggregated, GAT's switches)
CASES = {
    "gcn": ("GCNConv", False, False, {}),
    "gcn_bftiles": ("GCNConv", True, False, {}),
    "gcn_preagg_bftiles": ("GCNConv", True, True, {}),
    "sage": ("SAGEConv", False, False, {}),
    "sage_bftiles": ("SAGEConv", True, False, {}),
    "gin": ("GINConv", False, False, {}),
    "gin_bftiles": ("GINConv", True, False, {}),
}


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, ref, tol, scale):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=tol * scale)


def _port_model(name, in_dim, preagg, dtype, params):
    model = NodeModel(name, in_dim, 32, 2, 4, dropout_rate=0.0, dtype=dtype,
                      first_layer_preaggregated=preagg)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, params)))
    return model


def _at_edge(g, jax_g, name, bf_tiles, block, min_block_edges):
    """Both packages' graphs with their operators rebuilt at tile edge
    ``block`` (``build_hybrid(block=...)`` on the reordered graph, as
    bench.py's ``FITGNN_BENCH_BLOCK`` builds it)."""
    n = g.num_nodes_padded
    s = g.senders.numpy().astype(np.int64)
    r = g.receivers.numpy().astype(np.int64)
    kw = dict(min_block_edges=min_block_edges, block=block, use_segmm=True,
              semantics=_LAYER_SEMANTICS[name], real_nodes=n)
    ht = build_hybrid(s, r, _operator_weights(
        s, r, g.edge_weight.numpy(), n, kw["semantics"]), n,
        tile_dtype=BF16 if bf_tiles else None, **kw)
    hj = jax_build_hybrid(s, r, jax_operator_weights(
        s, r, np.asarray(jax_g.edge_weight), n, kw["semantics"]), n,
        tile_dtype=jnp.bfloat16 if bf_tiles else None, **kw)
    return g._replace(aux=ht), jax_g._replace(aux=hj)


def check_case(monkeypatch, name, bf_tiles, preagg, switches, block=128,
               min_block_edges=80):
    """The bf16 model of one case against the JAX package's (see the module
    note), its operator at tile edge ``block`` and threshold
    ``min_block_edges``; above 128 on a graph of ``N`` nodes rounded up to
    a multiple of ``block``, less 12 (room for the padding node)."""
    for k, v in switches.items():
        monkeypatch.setattr(jax_tile_gat_mod, f"_{k}", v)
        monkeypatch.setenv(f"FITGNN_GAT_{k}", "1")
    rng = np.random.default_rng(6)
    n = N if block == 128 else -(-N // block) * block - 12
    x, s, r = community_graph(rng, n, 16)
    y = rng.integers(0, 4, n)
    mask = rng.random(n) < 0.5
    kw = dict(y=y, train_mask=mask, min_block_edges=min_block_edges,
              layer_name=name)
    gt, _ = build_optimized_graph(x, s, r, tile_dtype=BF16 if bf_tiles
                                  else None, **kw)
    gj, _ = jax_build_optimized_graph(x, s, r, tile_dtype=jnp.bfloat16
                                      if bf_tiles else None, **kw)
    if block != 128:
        gt, gj = _at_edge(gt, gj, name, bf_tiles, block, min_block_edges)
    assert gt.aux.segmm is not None and gt.aux.bsr is not None
    assert gt.aux.bsr.bf16 == bf_tiles and gt.aux.bsr.block == block
    xj, xt = gj.x, gt.x
    if preagg:
        xj = jax_preaggregate_input(gj, name)
        xt = preaggregate_input(gt, name)
        gt = gt._replace(x=xt)
    jm = JaxNodeModel(layer_name=name, hidden=32, num_layers=2, out_dim=4,
                      dropout_rate=0.0, dtype=jnp.bfloat16,
                      first_layer_preaggregated=preagg)
    params = jm.init(jax.random.PRNGKey(2), xj, gj)

    def loss_j(p):
        return jax_losses.masked_nll(jm.apply(p, xj, gj), gj.y,
                                     gj.train_mask)

    ref_out = np.asarray(jm.apply(params, xj, gj))
    loss_ref, grads = jax.value_and_grad(loss_j)(params)

    model = _port_model(name, xt.shape[1], preagg, BF16, params)
    seen = []
    for layer in model.convs.layers:
        layer.register_forward_hook(
            lambda mod, args, out: seen.append(out.dtype))
    model.eval()
    with torch.no_grad():
        out = model(xt, gt)
    assert out.dtype == torch.float32
    assert seen == [BF16, BF16]
    _close(out, ref_out, 2e-2, max(1.0, float(np.abs(ref_out).max())))

    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    loss = steps.gc_train_step(model, opt, gt, gt.y, gt.train_mask, None,
                               "classification")
    assert seen[2:] == [BF16, BF16]
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-2)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    f32 = None
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all(), k
        if not k.endswith("att_dst"):
            _close(p.grad, ref[k], 5e-2, float(ref[k].abs().max()))
            continue
        if f32 is None:
            wide = _port_model(name, xt.shape[1], preagg, None, params)
            steps.gc_train_step(wide, steps.adam_l2(wide.parameters(), 0.01,
                                                    5e-4),
                                gt, gt.y, gt.train_mask, None,
                                "classification")
            f32 = dict(wide.named_parameters())
        exact = _np(f32[k].grad)
        scale = float(np.abs(exact).max())
        port_err = float(np.abs(_np(p.grad) - exact).max())
        jax_err = float(np.abs(_np(ref[k]) - exact).max())
        assert port_err <= max(1.5 * jax_err, 1e-6 * scale), (k, port_err,
                                                              jax_err)
        assert port_err <= 1e-1 * scale, (k, port_err, scale)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_node_model_matches_jax(monkeypatch, case):
    check_case(monkeypatch, *CASES[case])
