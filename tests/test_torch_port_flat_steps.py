"""The port's flat data-mesh steps (``parallel/dist_train.py``) against
the JAX package's ``make_dist_train_step`` / ``make_halo_train_step`` /
``make_dist_eval_step`` on 4 host devices, the port in one gloo world of
4 ranks (``torch_port_dist_worker.py``'s ``flat_train`` cases).

From the JAX package's ``create_dist_state`` parameters (loaded through
``models.convert.params_from_flax`` unchanged), three steps at
``dropout_rate=0`` (Adam with L2), then the eval on the val rows: GCN
classification on the all-gather and on the halo table (the JAX halo step
on the all-gather model's state, as the two trees interchange), and GAT
regression on the halo table.  The losses, every parameter after the
steps and the eval's (loss, metric) within rtol 1e-4, atol 1e-4·max|ref|,
and the parameters bit for bit the same on every rank.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from fitgnn_tpu.graph.optimize import _LAYER_SEMANTICS as JAX_SEM
from fitgnn_tpu.parallel import (DistNodeModel as JaxDistNodeModel,
                                 DistNodeModelHalo as JaxDistNodeModelHalo,
                                 build_halo_plan as jax_build_halo_plan,
                                 create_dist_state as jax_create_dist_state,
                                 make_dist_eval_step, make_dist_train_step,
                                 make_halo_train_step,
                                 make_mesh as jax_make_mesh,
                                 shard_graph as jax_shard_graph)

from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.parallel import build_halo_plan

from torch_port_dist_worker import World
from torch_port_flat_cases import P, close, graph, sharded

torch.set_num_threads(1)

LR, WD, STEPS, HIDDEN = 0.01, 5e-4, 3, 16
CONFIGS = [("GCNConv", "classification", "gather"),
           ("GCNConv", "classification", "halo"),
           ("GATConv", "regression", "halo")]


def name_of(cfg):
    return "_".join((cfg[0], cfg[1][:3], cfg[2]))


def _model(cls, layer, task):
    return cls(hidden=HIDDEN, num_layers=2,
               out_dim=3 if task == "classification" else 1,
               classify=task == "classification", dropout_rate=0.0,
               layer_name=layer)


@functools.lru_cache(maxsize=None)
def jax_inputs(layer, task):
    """(JAX sharded graph, its halo plan, create_dist_state's state)."""
    x, s, r, y, train, val = graph(task)
    sg = jax_shard_graph(x, s, r, y, P, train_mask=train, val_mask=val,
                         semantics=JAX_SEM[layer])
    plan = jax_build_halo_plan(np.asarray(sg.senders),
                               np.asarray(sg.receivers),
                               np.asarray(sg.edge_weight), P,
                               sg.nodes_per_shard)
    state = jax_create_dist_state(_model(JaxDistNodeModel, layer, task),
                                  jax.random.PRNGKey(3), sg, LR, WD)
    return sg, plan, state


def _flax_to_port(params):
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = []
    for cfg in CONFIGS:
        layer, task, table = cfg
        sg = sharded(layer, task)
        cases.append((name_of(cfg), dict(
            kind="flat_train", sg=sg,
            plan=build_halo_plan(sg.senders, sg.receivers, sg.edge_weight,
                                 P, sg.nodes_per_shard),
            layer=layer, task=task, table=table, hidden=HIDDEN,
            out_dim=3 if task == "classification" else 1,
            params=_flax_to_port(jax_inputs(layer, task)[2].params),
            lr=LR, wd=WD, steps=STEPS)))
    w = World(cases, tmp_path_factory.mktemp("flat_steps"))
    yield w
    w.wait()


@pytest.mark.parametrize("cfg", CONFIGS, ids=name_of)
def test_flat_steps_match_jax(world, cfg):
    layer, task, table = cfg
    sg, plan, state = jax_inputs(layer, task)
    mesh = jax_make_mesh(P)
    model = _model(JaxDistNodeModel, layer, task)
    with mesh:
        if table == "halo":
            step = make_halo_train_step(
                mesh, _model(JaxDistNodeModelHalo, layer, task), plan)

            def run(state, key):
                return step(state, sg.x, sg.y, sg.train_mask, plan, key)
        else:
            step = make_dist_train_step(mesh, model)

            def run(state, key):
                return step(state, sg, key)
        losses = []
        for i in range(STEPS):
            state, loss = run(state, jax.random.PRNGKey(i))
            losses.append(float(loss))
        ev = make_dist_eval_step(mesh, model, "val")(state, sg)
    ref = _flax_to_port(state.params)
    res = world.results(name_of(cfg))
    for r in res:
        close(r["losses"], losses, "losses")
        close(r["eval"], [float(v) for v in ev], "eval (loss, metric)")
        assert set(r["params"]) == set(ref)
        for k, v in ref.items():
            close(r["params"][k], v, k)
        for k, v in r["params"].items():       # replicated bit for bit
            np.testing.assert_array_equal(v, res[0]["params"][k], err_msg=k)
    assert losses[-1] < losses[0]
