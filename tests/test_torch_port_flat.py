"""The port's flat data-mesh library (``parallel/halo.py``,
``dist_model.py``) against the JAX package's, on the CPU.

The JAX side runs under ``shard_map`` on 4 of the host devices
``conftest.py`` forces; the port's in one gloo world of 4 ranks
(``torch_port_dist_worker.py``'s ``flat_layers`` cases, started once for
the file and running while the JAX side compiles).  Held here:

* ``build_halo_plan``'s five arrays exactly, at P = 4 and P = 1 (all
  padding: K = 8, the mask all false), and the sender remap's meaning;
* ``halo_exchange``'s rows: each received row is the sending shard's row
  that the plan names, zero on padding;
* GCN, SAGE, GIN and GAT (``make_dist_conv``) on the all-gather and the
  halo table, each from the same parameters: the output, and the gradient
  of Σ tanh(out) over every rank in the shard's rows (which only the
  exchanges' backward passes carry across ranks) and in the parameters
  summed over the ranks, within rtol 1e-4, atol 1e-4·max|ref|;
* ``create_dist_state``: the same parameters on every rank, flax's init
  drawn from the seed (``NodeModel.reset_parameters``'s).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as PS

from fitgnn_tpu.parallel import DATA_AXIS
from fitgnn_tpu.parallel import build_halo_plan as jax_build_halo_plan
from fitgnn_tpu.parallel import make_dist_conv as jax_make_dist_conv
from fitgnn_tpu.parallel import make_mesh as jax_make_mesh

from fitgnn_tpu_torch.models.layers import make_layer
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.parallel import build_halo_plan

from torch_port_dist_worker import World
from torch_port_flat_cases import LAYERS, P, close, sharded, to_flax

torch.set_num_threads(1)

HIDDEN, SEED = 16, 5


def layer_params(layer):
    """The layer's parameters from ``reset_parameters`` (flax's init)."""
    conv = make_layer(layer, 12, HIDDEN)
    conv.reset_parameters(torch.Generator().manual_seed(7))
    with torch.no_grad():     # GIN's eps away from its initial 0
        for name, p in conv.named_parameters():
            if name == "eps":
                p.fill_(0.25)
    return {k: v.detach().numpy().copy()
            for k, v in conv.state_dict().items()}


def plan_of(sg):
    return build_halo_plan(sg.senders, sg.receivers, sg.edge_weight,
                           sg.num_shards, sg.nodes_per_shard)


CASES = {layer: dict(kind="flat_layers", sg=sharded(layer),
                     plan=plan_of(sharded(layer)), layer=layer,
                     hidden=HIDDEN, params=layer_params(layer), seed=SEED)
         for layer in LAYERS}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(list(CASES.items()), tmp_path_factory.mktemp("flat"))
    yield w
    w.wait()


# ---- the plan, host numpy ---------------------------------------------------

@pytest.mark.parametrize("shards", [P, 1])
def test_halo_plan_matches_jax(shards):
    sg = sharded("GCNConv", shards=shards)
    got = plan_of(sg)
    ref = jax_build_halo_plan(sg.senders, sg.receivers, sg.edge_weight,
                              shards, sg.nodes_per_shard)
    for name in ref._fields:
        a, b = getattr(got, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.k == ref.k and got.k % 8 == 0 and got.k >= 8
    for p in range(shards):
        assert not got.send_mask[p, p].any()     # no slot of its own
    if shards == 1:
        assert got.k == 8 and not got.send_mask.any()
        np.testing.assert_array_equal(got.senders_ext, sg.senders)
        return
    # a remote sender v of shard q owned by p is n_loc + p·K + its place
    n_loc, k = sg.nodes_per_shard, got.k
    for q in range(shards):
        s, ext = sg.senders[q].astype(np.int64), got.senders_ext[q]
        owner = s // n_loc
        np.testing.assert_array_equal(ext[owner == q], s[owner == q] % n_loc)
        rem = owner != q
        assert rem.any()
        slot = ext[rem] - n_loc
        np.testing.assert_array_equal(slot // k, owner[rem])
        np.testing.assert_array_equal(
            got.send_idx[owner[rem], q, slot % k], s[rem] % n_loc)
        assert got.send_mask[owner[rem], q, slot % k].all()


def test_halo_exchange_rows(world):
    """Slot p·K + j of shard q's table holds the row of shard p the plan
    names (shard p's row j is p·1000 + j), zero where p sends nothing."""
    res = world.results("GCNConv")
    plan = CASES["GCNConv"]["plan"]
    k = plan.k
    for q, r in enumerate(res):
        rows = r["halo_rows"]
        assert rows.shape == (P * k, 3)
        want = np.where(plan.send_mask[:, q],
                        np.arange(P)[:, None] * 1000.0
                        + plan.send_idx[:, q], 0.0).reshape(-1)
        for c in range(3):
            np.testing.assert_array_equal(rows[:, c], want)
    assert plan.send_mask.any()


# ---- the layers on both tables ----------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_layer(layer):
    """The JAX layer on both tables under shard_map: per table the
    output, the gradient in the rows and the psum'd parameter gradient."""
    case = CASES[layer]
    sg, plan = case["sg"], case["plan"]
    convs = [jax_make_dist_conv(layer, HIDDEN, DATA_AXIS, "conv", halo=h)
             for h in (False, True)]
    mesh = jax_make_mesh(P)
    SH = PS(DATA_AXIS)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(PS(), SH, SH, SH, SH, SH, SH, SH),
                       out_specs=((SH, SH, PS()), (SH, SH, PS())),
                       check_vma=False)
    def run(params, x, s, se, r, w, si, sm):
        fns = (lambda p, h: convs[0].apply(p, h, s[0], r[0], w[0]),
               lambda p, h: convs[1].apply(p, h, se[0], r[0], w[0], si[0],
                                           sm[0]))
        outs = []
        for f in fns:
            gp, gx = jax.grad(lambda p, h: jnp.sum(jnp.tanh(f(p, h))),
                              argnums=(0, 1))(params, x[0])
            outs.append((f(params, x[0])[None], gx[None],
                         jax.lax.psum(gp, DATA_AXIS)))
        return tuple(outs)

    got = run(to_flax(layer, case["params"]), sg.x, sg.senders,
              plan.senders_ext, plan.receivers, plan.edge_weight,
              plan.send_idx, plan.send_mask)
    return {t: v for t, v in zip(("gather", "halo"), got)}


@pytest.mark.parametrize("table", ["gather", "halo"])
@pytest.mark.parametrize("layer", LAYERS)
def test_layer_matches_jax(world, layer, table):
    out, gx, gp = jax_layer(layer)[table]
    res = [r[table] for r in world.results(layer)]
    f = HIDDEN
    close(np.concatenate([r["out"] for r in res]), np.reshape(out, (-1, f)),
          f"{layer} {table} output")
    close(np.concatenate([r["x_grad"] for r in res]),
          np.reshape(gx, (-1, 12)), f"{layer} {table} gradient in x")
    assert np.abs(res[0]["x_grad"]).sum() > 0
    got = jax.tree_util.tree_leaves_with_path(
        to_flax(layer, res[0]["grads"])["params"])
    ref = dict(jax.tree_util.tree_leaves_with_path(gp["params"]))
    assert len(got) == len(ref)
    for path, v in got:
        close(np.asarray(v), ref[path], f"{layer} {table} grad {path}")
    for r in res[1:]:          # the summed gradients: every rank's
        for k, v in r["grads"].items():
            np.testing.assert_array_equal(v, res[0]["grads"][k])


def test_tables_interchange(world):
    """The halo and the all-gather table give each layer the same output
    (the halo table holds exactly the rows the edges reference)."""
    for layer in LAYERS:
        for r in world.results(layer):
            close(r["halo"]["out"], r["gather"]["out"], layer)
            close(r["halo"]["x_grad"], r["gather"]["x_grad"], layer)


def test_create_dist_state_replicated(world):
    ref = NodeModel("GATConv", 12, HIDDEN, 2, 3)
    ref.reset_parameters(torch.Generator().manual_seed(SEED))
    want = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    for r in world.results("GATConv"):
        assert set(r["created"]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(r["created"][k], v, err_msg=k)
