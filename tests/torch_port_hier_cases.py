"""The cases of the hierarchical train-step parity tests
(``test_torch_port_hier_steps.py``, ``_steps22.py`` and
``test_torch_port_hier_gat_steps.py``): the graph, both sides' inputs, the
gloo world that runs the port's steps and the comparison with the JAX
package's ``make_hier_train_step`` / ``make_hier_eval_step``.

From the JAX package's initial parameters of a ``HierNodeModel``
(``init_hier_params``, loaded through ``models.convert.params_from_flax``
unchanged), three ``hier_train_step``s at ``dropout_rate=0`` (Adam with
L2), then ``hier_eval_step`` on the val rows, each on its layer's
semantics with the interior on the hybrid operator (GAT's on the tile
attention).  The losses, the first step's gradients (against the JAX
package's ``jax.grad`` of the same loss, psum'd over the mesh) and every
parameter after the steps within rtol 1e-4 and atol 1e-5 on every rank,
the eval's loss and metric likewise.  Adam's step barely moves when every
gradient is scaled alike, so the gradients are what show a sum over the
ranks taken as a mean, or a rank's gradient counted twice.
"""

import functools

import numpy as np

import jax

from fitgnn_tpu.graph.optimize import _LAYER_SEMANTICS as JAX_SEM
from fitgnn_tpu.parallel import (HierNodeModel as JaxHierNodeModel,
                                 build_hier_plan as jax_build_hier_plan,
                                 make_hier_eval_step, make_hier_mesh,
                                 make_hier_train_step,
                                 shard_graph as jax_shard_graph)
from fitgnn_tpu.parallel.hierarchical import (CHIP_AXIS, HOST_AXIS,
                                              init_hier_params)
from fitgnn_tpu.train.losses import task_loss_sums
from fitgnn_tpu.train.steps import TrainState, adam_l2

from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.parallel import shard_graph

from torch_port_dist_worker import World

LR, WD, STEPS, HIDDEN = 0.01, 5e-4, 3, 16


def name_of(cfg):
    layer, task, H, D = cfg
    return f"{layer}_{task[:3]}_{H}x{D}"


def graph(task):
    rng = np.random.default_rng(11)
    n, comm, f = 256, 32, 12
    e = n * 6
    r = rng.integers(0, n, e)
    s = np.where(rng.random(e) < 0.7, (r // comm) * comm
                 + rng.integers(0, comm, e), rng.integers(0, n, e))
    keep = s != r
    x = rng.standard_normal((n, f)).astype(np.float32)
    if task == "classification":
        y = ((np.arange(n) // comm) % 3).astype(np.int32)
    else:
        y = (x[:, 0] + 0.1 * rng.standard_normal(n)).astype(np.float32)
    split = rng.random(n)
    return x, s[keep], r[keep], y, split < 0.4, (split >= 0.4) & (split < 0.7)


def _model(layer, task):
    return JaxHierNodeModel(hidden=HIDDEN, num_layers=2,
                            out_dim=3 if task == "classification" else 1,
                            classify=task == "classification",
                            dropout_rate=0.0, layer_name=layer)


@functools.lru_cache(maxsize=None)
def jax_inputs(cfg):
    """(JAX sharded graph, plan arguments, initial parameters) of a
    configuration; the parameters depend on neither the mesh nor the plan,
    so they are made once a (layer, task), on a per-edge plan."""
    layer, task, H, D = cfg
    x, s, r, y, train, val = graph(task)
    sg = jax_shard_graph(x, s, r, y, H * D, train_mask=train, val_mask=val,
                         semantics=JAX_SEM[layer])
    cluster_of = np.arange(sg.num_nodes_global) // 32
    args = (np.asarray(sg.senders), np.asarray(sg.receivers),
            np.asarray(sg.edge_weight), H, D, sg.nodes_per_shard, cluster_of)
    return sg, args, _init_params(layer, task)


@functools.lru_cache(maxsize=None)
def _init_params(layer, task):
    x, s, r, y, _, _ = graph(task)
    sg = jax_shard_graph(x, s, r, y, 1, semantics=JAX_SEM[layer])
    plan = jax_build_hier_plan(np.asarray(sg.senders),
                               np.asarray(sg.receivers),
                               np.asarray(sg.edge_weight), 1, 1,
                               sg.nodes_per_shard,
                               np.arange(sg.num_nodes_global) // 32,
                               interior_hybrid=False)
    return init_hier_params(_model(layer, task), plan, sg.x,
                            jax.random.PRNGKey(3))


def start_world(configs, tmp_dir) -> World:
    """The port's side of every configuration, in one gloo world of 4."""
    cases = []
    for cfg in configs:
        layer, task, H, D = cfg
        _, args, params = jax_inputs(cfg)
        x, s, r, y, train, val = graph(task)
        sg = shard_graph(x, s, r, y, H * D, train_mask=train, val_mask=val,
                         semantics=JAX_SEM[layer])
        cases.append((name_of(cfg), dict(
            kind="train", H=H, D=D, sg=sg, cluster_of=args[-1],
            plan=dict(interior_hybrid=True, min_block_edges=4,
                      interior_semantics=JAX_SEM[layer]),
            layer=layer, task=task, hidden=HIDDEN,
            out_dim=3 if task == "classification" else 1,
            params={k: v.numpy() for k, v in params_from_flax(
                jax.tree_util.tree_map(np.asarray, params)).items()},
            lr=LR, wd=WD, steps=STEPS)))
    return World(cases, tmp_dir)


def close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(ref, dtype=np.float32),
                               rtol=1e-4, atol=1e-5, err_msg=what)


def jax_grads(mesh, model, plan, params, sg, task):
    """The gradients of ``make_hier_train_step``'s first step: the same
    loss, its ``jax.grad`` on every shard, psum'd over the mesh."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    axes = (HOST_AXIS, CHIP_AXIS)
    SH = P(axes)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), SH, SH, SH, jax.tree_util.tree_map(lambda _: SH,
                                                          plan)),
        out_specs=P(), check_vma=False)
    def grads(params, xb, yb, mb, plan_b):
        pb = jax.tree_util.tree_map(lambda a: a[0], plan_b)

        def loss_fn(p):
            out = model.apply(p, xb[0], pb, train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)})
            local_sum, local_cnt = task_loss_sums(task, out, yb[0], mb[0])
            return local_sum / jax.numpy.maximum(
                jax.lax.psum(local_cnt, axes), 1.0)

        return jax.lax.psum(jax.grad(loss_fn)(params), axes)

    with mesh:
        out = jax.jit(grads)(params, sg.x, sg.y, sg.train_mask, plan)
    return params_from_flax(jax.tree_util.tree_map(np.asarray, out))


def check_steps(world, cfg):
    """The JAX package's steps of ``cfg`` against the world's ranks."""
    layer, task, H, D = cfg
    sg, args, params = jax_inputs(cfg)
    plan = jax_build_hier_plan(*args, interior_hybrid=True,
                               min_block_edges=4,
                               interior_semantics=JAX_SEM[layer])
    assert plan.int_hybrid.bsr.nnz_blocks > 0
    mesh = make_hier_mesh(H, D)
    model = _model(layer, task)
    state = TrainState.create(apply_fn=model.apply, params=params,
                              tx=adam_l2(LR, WD))
    step = make_hier_train_step(mesh, model, plan)
    with mesh:
        losses = []
        for i in range(STEPS):
            state, loss = step(state, sg.x, sg.y, sg.train_mask, plan,
                               jax.random.PRNGKey(i))
            losses.append(float(loss))
        ev = make_hier_eval_step(mesh, model, plan)(state, sg.x, sg.y,
                                                    sg.val_mask, plan)
    grads = jax_grads(mesh, model, plan, params, sg, task)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, state.params))
    for r in world.results(name_of(cfg)):   # the state is every rank's
        close(r["losses"], losses, "losses")
        close(r["eval"], [float(v) for v in ev], "eval (loss, metric)")
        assert set(r["grads"]) == set(grads)
        for k, v in grads.items():
            close(r["grads"][k], v.numpy(), f"first step's gradient {k}")
        assert set(r["params"]) == set(ref)
        for k, v in ref.items():
            close(r["params"][k], v.numpy(), k)
    assert losses[-1] < losses[0]
