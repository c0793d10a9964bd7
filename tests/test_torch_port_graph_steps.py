"""The port's graph-level steps against the JAX package, on the CPU: the
loss and its gradients with padding samples present, ``graph_eval_sums``
and ``graph_eval_step`` (classification, regression, ``--multi_prop``),
and ``graph_inference_benchmark`` in both views.

Inputs and tolerances as in ``test_torch_port_graph_level.py``: forwards
and sums within rtol 1e-5 and atol 1e-5·max|ref|, gradients within rtol
1e-4.
"""

import numpy as np
import pytest
import torch

from fitgnn_tpu.bench.graph_inference import \
    graph_inference_benchmark as jax_graph_inference
from fitgnn_tpu.data import graph_level as jax_gl
from fitgnn_tpu.train import graph_loop as jax_loop
from fitgnn_tpu.train.steps import TrainState, adam_l2

from fitgnn_tpu_torch.bench.graph_inference import graph_inference_benchmark
from fitgnn_tpu_torch.data import graph_level as gl
from fitgnn_tpu_torch.train import graph_loop as loop

from test_torch_port_graph_level import (LAYERS, assert_grads_close, close,
                                         dataset, jax_grads, jax_model,
                                         port_grads, port_model, samples)

torch.set_num_threads(1)


@pytest.mark.parametrize("view", ["gc", "gs"])
@pytest.mark.parametrize("classify", [True, False], ids=["cls", "reg"])
@pytest.mark.parametrize("layer", LAYERS)
def test_loss_and_gradients_with_padding_match_jax(layer, classify, view):
    """Eval mode; the last chunk of 7 holds padding samples, which add
    nothing to the loss and give no NaN."""
    ours, theirs = samples("extra_node", regression=not classify)
    got_b = gl.collate_graph_level_batches(ours, 7)[-1]
    ref_b = jax_gl.collate_graph_level_batches(theirs, 7)[-1]
    assert int(got_b.graph_mask.sum()) < got_b.num_graphs
    out_dim = 2 if classify else 1
    jm, params = jax_model(layer, classify, out_dim, ref_b)
    m = port_model(layer, classify, out_dim, got_b.gc.x.shape[1], params)
    loss_ref, g_ref = jax_grads(jm, params, ref_b, classify, view)
    loss, g = port_grads(m, got_b, classify, view)
    close(loss, loss_ref)
    assert_grads_close(m, g, g_ref)


@pytest.mark.parametrize("classify,prop", [(True, None), (False, None),
                                           (False, 1)],
                         ids=["cls", "reg", "multi_prop"])
@pytest.mark.parametrize("view", ["gc", "gs"])
def test_eval_sums_and_step_match_jax(view, classify, prop):
    graphs, y = dataset()
    if prop is not None:
        y = np.stack([[x.shape[0], len(s) / x.shape[0]] for x, s, _ in graphs]
                     ).astype(np.float32)
    ours = [gl.prepare_graph_sample(x, s, r, y_, reduction=0.5)
            for (x, s, r), y_ in zip(graphs, y)]
    ours_b = gl.collate_graph_level_batches(ours, 10)[-1]
    theirs = [jax_gl.prepare_graph_sample(x, s, r, y_, reduction=0.5)
              for (x, s, r), y_ in zip(graphs, y)]
    ref_b = jax_gl.collate_graph_level_batches(theirs, 10)[-1]
    out_dim = 2 if classify else 1
    jm, params = jax_model("SAGEConv", classify, out_dim, ref_b)
    m = port_model("SAGEConv", classify, out_dim, ours_b.gc.x.shape[1],
                   params)
    state = TrainState.create(apply_fn=jm.apply, params=params,
                              tx=adam_l2(0.01, 5e-4))
    got = loop.graph_eval_sums(m, ours_b, classify, prop, view)
    ref = jax_loop.graph_eval_sums(state, ref_b, classify, prop, view)
    for a, b in zip(got, ref):
        close(a, b)
    assert float(got[2]) == int(ours_b.graph_mask.sum())
    for a, b in zip(loop.graph_eval_step(m, ours_b, classify, prop, view),
                    jax_loop.graph_eval_step(state, ref_b, classify, prop,
                                             view)):
        close(a, b)


@pytest.mark.parametrize("classify", [True, False], ids=["cls", "reg"])
@pytest.mark.parametrize("view", ["gs", "gc"])
def test_graph_inference_matches_jax(view, classify):
    ours, theirs = samples("extra_node", regression=not classify)
    _, y = dataset(regression=not classify)
    out_dim = 2 if classify else 1
    jm, params = jax_model("GCNConv", classify, out_dim,
                           jax_gl.collate_graph_level(theirs[:1]))
    m = port_model("GCNConv", classify, out_dim, ours[0].coarse_x.shape[1],
                   params)
    got = graph_inference_benchmark(m, ours[:6], y[:6], view=view,
                                    classify=classify)
    ref = jax_graph_inference(jm, params, theirs[:6], y[:6], view=view,
                              classify=classify)
    assert got.num_test_samples == ref.num_test_samples == 6
    assert got.acc == ref.acc
    close(got.avg_loss, ref.avg_loss)
    assert got.avg_inf_time > 0 and got.avg_inf_time_device > 0
    with pytest.raises(ValueError, match="view"):
        graph_inference_benchmark(m, ours[:1], y[:1], view="both")
