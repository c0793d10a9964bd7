"""One train step on f16 and fp8 e4m3 tiles against the JAX package, on
the CPU: GCN on each type, GAT two-stage on f16 and under
``FITGNN_GAT_FUSED_TILES=1`` on e4m3, each on the operator ``build_optimized_graph(tile_dtype=...)`` builds
(its tiles' bytes equal the JAX package's).  The loss, every gradient and
the parameters after Adam with L2 are held as
``tests/test_torch_port_bf16.py`` holds its bf16 steps (rtol 1e-4, atol
1e-5·max(1, max|ref|)).  The JAX Pallas kernels run in interpret mode;
the port's wrappers take their plain versions on the CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fitgnn_tpu.ops.tile_gat as jax_tile_gat_mod
import fitgnn_tpu.train.steps as jax_steps
from fitgnn_tpu.graph.optimize import \
    build_optimized_graph as jax_build_optimized_graph
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.train import losses as jax_losses

from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.train import steps

from test_torch_port_bf16 import close_step
from test_torch_port_sage_gin import community_graph
from test_torch_port_tiletypes import TYPES, bits

torch.set_num_threads(1)


GAT_SWITCHES = {"GATConv": ({}, {}),
                "GATConv_fused": ({"_FUSED_TILES": True},
                                  {"FITGNN_GAT_FUSED_TILES": "1"})}


@pytest.mark.parametrize("kind,layer", [
    ("e4m3", "GCNConv"), ("f16", "GCNConv"), ("f16", "GATConv"),
    ("e4m3", "GATConv_fused")])
def test_train_step_matches_jax(monkeypatch, kind, layer):
    """One Gc train step (``gc_train_step``) on the layer's operator from
    ``build_optimized_graph(tile_dtype=...)``, dropout off: the loss,
    every gradient and the parameters after Adam with L2.  GAT two-stage
    (K4 on the mask of the type) and under ``FITGNN_GAT_FUSED_TILES=1`` (K7
    on it).  No wrapper launches a kernel on the CPU."""
    flags, env = GAT_SWITCHES.get(layer, ({}, {}))
    for k, v in flags.items():
        monkeypatch.setattr(jax_tile_gat_mod, k, v)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    dt, jdt, _ = TYPES[kind]
    name = layer.split("_")[0]
    rng = np.random.default_rng(6)
    x, s, r = community_graph(rng, 384, 16)
    y = rng.integers(0, 4, 384)
    mask = rng.random(384) < 0.5
    kw = dict(y=y, train_mask=mask, min_block_edges=80, layer_name=name)
    gt, _ = build_optimized_graph(x, s, r, tile_dtype=dt, **kw)
    gj, _ = jax_build_optimized_graph(x, s, r, tile_dtype=jdt, **kw)
    assert gt.aux.bsr.blocks.dtype == dt
    np.testing.assert_array_equal(bits(gt.aux.bsr.blocks, kind),
                                  bits(gj.aux.bsr.blocks, kind))
    jm = JaxNodeModel(layer_name=name, hidden=32, num_layers=2, out_dim=4,
                      dropout_rate=0.0)
    # seeded parameters of init's shapes (traced, not compiled), and
    # gc_train_step's body as one compiled call: dropout is off, so its
    # loss is this one
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(2), gj.x, gj)
    prng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.3 * prng.standard_normal(a.shape), a.dtype),
        shapes)
    state = jax_steps.TrainState.create(apply_fn=jm.apply, params=params,
                                        tx=jax_steps.adam_l2(0.01, 5e-4))

    @jax.jit
    def step_j(st):
        val, grads = jax.value_and_grad(lambda p: jax_losses.masked_nll(
            jm.apply(p, gj.x, gj), gj.y, gj.train_mask))(st.params)
        return val, grads, st.apply_gradients(grads=grads)

    loss_ref, grads, new = step_j(state)
    model = NodeModel(name, 16, 32, 2, 4, dropout_rate=0.0)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, state.params)))
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    loss = steps.gc_train_step(model, opt, gt, gt.y, gt.train_mask, None,
                               "classification")
    close_step(loss, loss_ref)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    for k, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), k
        close_step(p.grad, ref[k])
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, new.params))
    for k, v in model.state_dict().items():
        close_step(v, ref[k])
