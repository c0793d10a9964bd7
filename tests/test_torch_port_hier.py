"""The port's hierarchical distributed layer against the JAX package's, on
the CPU.

The JAX side runs in this process on the host devices ``conftest.py``
forces, under ``shard_map`` over a (host × chip) mesh; the port's runs in
one gloo world of 4 ranks (``torch_port_dist_worker.py``, started once for
the file and running while the JAX side compiles), each rank one shard.
Held here:

* the host-side numpy: ``shard_graph`` under each layer's semantics,
  ``shard_prebuilt_graph``, ``shard_node_array``,
  ``placement_by_community`` and every table of ``build_hier_plan`` at
  (H, D) = (1, 4) and (2, 2), both summaries, exactly; the spanning-cluster
  rejection and the mesh's refusal of P that H does not divide;
* ``hier_aggregate`` against the JAX package and the dense oracle, with
  and without the interior hybrid operator (H=1 within 1e-5, H=2 within
  1e-4), and the gradient of Σ tanh(out) over every rank, which only the
  collectives' backward passes carry across shards;
* ``hier_attention_aggregate`` on the per-edge branch and on the tile
  interior under the global-max bound and the exact max
  (``FITGNN_GAT_GLOBAL_MAX=0``, the JAX module global set to match),
  outputs and gradients within 1e-4;
* ``tile_gat_attention(partials=True, src_score_bound=…, extra_rowmax=…)``
  on one process (no world) under both maxima, with gradients.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as PS

from fitgnn_tpu.ops import tile_gat as jax_tile_gat
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.parallel import (CHIP_AXIS, HOST_AXIS,
                                 build_hier_plan as jax_build_hier_plan,
                                 hier_aggregate as jax_hier_aggregate,
                                 hier_attention_aggregate as jax_hier_att,
                                 make_hier_mesh as jax_make_hier_mesh,
                                 shard_graph as jax_shard_graph)
from fitgnn_tpu.parallel.multihost import \
    placement_by_community as jax_placement
from fitgnn_tpu.parallel.shard import (
    shard_node_array as jax_shard_node_array,
    shard_prebuilt_graph as jax_shard_prebuilt_graph)

from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
from fitgnn_tpu_torch.ops.tile_gat import tile_gat_attention
from fitgnn_tpu_torch.parallel import (LAYER_SEMANTICS, build_hier_plan,
                                       chips_per_host,
                                       hier_oracle_features,
                                       placement_by_community, shard_graph,
                                       shard_node_array,
                                       shard_prebuilt_graph)

from torch_port_dist_worker import World

torch.set_num_threads(1)

MESHES = [(1, 4), (2, 2)]
TABLES = ("int_senders", "int_receivers", "int_weights", "halo_senders",
          "halo_receivers", "halo_weights", "send_idx", "send_mask",
          "sum_senders", "sum_receivers", "sum_weights", "cluster_local",
          "cluster_scale")


def community_graph(n=128, comm=16, f=8, seed=0):
    """A community-ordered graph (``tests/test_hierarchical.py``'s)."""
    rng = np.random.default_rng(seed)
    e = n * 6
    r = rng.integers(0, n, e)
    intra = rng.random(e) < 0.7
    s = np.where(intra, (r // comm) * comm + rng.integers(0, comm, e),
                 rng.integers(0, n, e))
    keep = s != r
    s, r = s[keep], r[keep]
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int32)
    return x, s.astype(np.int64), r.astype(np.int64), y


def global_edges(sg):
    """The (global senders, global receivers, weights) the shards hold,
    padding edges dropped."""
    n_loc = sg.nodes_per_shard
    r = np.asarray(sg.receivers) + (np.arange(sg.num_shards)
                                    * n_loc)[:, None]
    s, w = np.asarray(sg.senders).reshape(-1), np.asarray(
        sg.edge_weight).reshape(-1)
    keep = w != 0
    return s[keep], r.reshape(-1)[keep], w[keep]


# ---- the cases, numpy inputs for both sides --------------------------------

def agg_case(H, D, interior):
    x, s, r, y = community_graph()
    sg = shard_graph(x, s, r, y, 4)
    return dict(kind="aggregate", H=H, D=D, sg=sg,
                cluster_of=np.arange(sg.num_nodes_global) // 8,
                plan=dict(interior_hybrid=interior, min_block_edges=4))


def att_case(H, D, branch):
    exact = branch == "exact"
    x, s, r, y = community_graph(n=256, comm=32, f=12, seed=7 if exact
                                 else 0)
    sg = shard_graph(x, s, r, y, 4)
    rng = np.random.default_rng(2 if exact else 1)
    scale = 3.0 if exact else 1.0        # a wide score spread under exact
    plan = (dict(interior_hybrid=False) if branch == "edge" else
            dict(interior_hybrid=True, interior_semantics="att_unit",
                 min_block_edges=4))
    return dict(kind="attention", H=H, D=D, sg=sg,
                weights=(sg.edge_weight > 0).astype(np.float32),
                cluster_of=np.arange(sg.num_nodes_global) // 32, plan=plan,
                a_src=(scale * rng.standard_normal(12)).astype(np.float32),
                a_dst=(scale * rng.standard_normal(12)).astype(np.float32),
                env={"FITGNN_GAT_GLOBAL_MAX": "0" if exact else "1"})


AGG = {f"agg_{H}x{D}_{'hybrid' if i else 'edge'}": agg_case(H, D, i)
       for H, D in MESHES for i in (False, True)}
ATT = {f"att_{H}x{D}_{b}": att_case(H, D, b)
       for H, D in MESHES for b in ("edge", "global", "exact")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(list({**AGG, **ATT}.items()), tmp_path_factory.mktemp("hier"))
    yield w
    w.wait()


def port_result(world, name):
    res = world.results(name)
    return {k: np.concatenate([r[k] for r in res]) for k in res[0]}


def jax_run(case, fn):
    """``fn(h, plan_b)`` on every shard under ``shard_map``: the output and
    the gradient of Σ tanh(out) in each shard's rows, reassembled."""
    sg, H, D = case["sg"], case["H"], case["D"]
    w = case.get("weights", sg.edge_weight)
    plan = jax_build_hier_plan(sg.senders, sg.receivers, w, H, D,
                               sg.nodes_per_shard, case["cluster_of"],
                               **case["plan"])
    mesh = jax_make_hier_mesh(H, D)
    SH = PS((HOST_AXIS, CHIP_AXIS))
    spec = jax.tree_util.tree_map(lambda _: SH, plan)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(SH, spec),
                       out_specs=(SH, SH), check_vma=False)
    def run(hb, plan_b):
        pb = jax.tree_util.tree_map(lambda a: a[0], plan_b)
        out = fn(hb[0], pb)
        g = jax.grad(lambda h: jnp.sum(jnp.tanh(fn(h, pb))))(hb[0])
        return out[None], g[None]

    out, g = run(jnp.asarray(sg.x), plan)
    f = sg.x.shape[-1]
    return np.asarray(out).reshape(-1, f), np.asarray(g).reshape(-1, f)


# ---- host-side numpy, exactly ------------------------------------------------

@pytest.mark.parametrize("semantics", [None, *LAYER_SEMANTICS.values()])
def test_shard_graph_matches_jax(semantics):
    x, s, r, y = community_graph(n=200, comm=20, seed=1)
    rng = np.random.default_rng(4)
    masks = {k: rng.random(200) < 0.4 for k in ("train_mask", "val_mask",
                                                 "test_mask")}
    order = rng.permutation(200)
    got = shard_graph(x, s, r, y, 4, order=order, semantics=semantics,
                      **masks)
    ref = jax_shard_graph(x, s, r, y, 4, order=order, semantics=semantics,
                          **masks)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_prebuilt_node_array_and_placement_match_jax():
    x, s, r, y = community_graph(n=200, comm=20, seed=2)
    w = np.random.default_rng(5).random(len(s)).astype(np.float32)
    w[::7] = 0.0                                  # padding edges drop out
    labels = np.random.default_rng(6).integers(0, 13, 200)
    for shards in (1, 3, 4):
        got = placement_by_community(labels, shards)
        ref = jax_placement(labels, shards)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    order = got[0]
    got = shard_prebuilt_graph(x, s, r, w, y, 4, order=order,
                               train_mask=labels < 5)
    ref = jax_shard_prebuilt_graph(x, s, r, w, y, 4, order=order,
                                   train_mask=labels < 5)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(
        shard_node_array(labels, 4, 56, order=order, fill=-1),
        np.asarray(jax_shard_node_array(labels, 4, 56, order=order,
                                        fill=-1)))


@pytest.mark.parametrize("H,D", MESHES)
@pytest.mark.parametrize("summary", ["mean", "isometry"])
def test_hier_plan_tables_match_jax(H, D, summary):
    x, s, r, y = community_graph(n=256, comm=32, f=12, seed=3)
    sg = shard_graph(x, s, r, y, H * D, semantics="gcn_norm")
    cluster_of = np.arange(sg.num_nodes_global) // 16
    args = (sg.senders, sg.receivers, sg.edge_weight, H, D,
            sg.nodes_per_shard, cluster_of)
    got = build_hier_plan(*args, summary=summary, min_block_edges=4)
    ref = jax_build_hier_plan(*args, summary=summary, min_block_edges=4)
    for name in TABLES:
        a, b = getattr(got, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.num_hosts, got.chips_per_host) == (H, D)
    assert (got.halo_k, got.clusters_per_shard) == (ref.halo_k,
                                                     ref.clusters_per_shard)
    # each rank's interior operator: the JAX package's stacked shard, its
    # padding (zero tiles repeating the last row, zero-weight edges) aside
    for p in range(H * D):
        hyb = got.interior_hybrid(p)
        jb = jax.tree_util.tree_map(lambda a: np.asarray(a[p]),
                                    ref.int_hybrid)
        k = hyb.bsr.nnz_blocks
        np.testing.assert_array_equal(hyb.bsr.blocks.numpy(),
                                      jb.bsr.blocks[:k])
        np.testing.assert_array_equal(hyb.bsr.rows.numpy(), jb.bsr.rows[:k])
        np.testing.assert_array_equal(hyb.bsr.cols.numpy(), jb.bsr.cols[:k])
        assert not jb.bsr.blocks[k:].any()
        e = hyb.num_coo_edges
        for f in ("senders", "receivers", "weights"):
            np.testing.assert_array_equal(getattr(hyb, f).numpy(),
                                          getattr(jb, f)[:e], err_msg=f)
        assert not jb.weights[e:].any()
        assert hyb.dyn_plan is None and hyb.segmm is not None


def test_spanning_cluster_and_mesh_refusals():
    x, s, r, y = community_graph()
    sg = shard_graph(x, s, r, y, 4)
    with pytest.raises(ValueError, match="spans shards"):
        build_hier_plan(sg.senders, sg.receivers, sg.edge_weight, 2, 2,
                        sg.nodes_per_shard,
                        np.zeros(sg.num_nodes_global, dtype=np.int64))
    assert chips_per_host(4, 2) == 2
    with pytest.raises(ValueError,
                       match="--num_devices 3 must divide by --num_hosts 2"):
        chips_per_host(3, 2)


# ---- the exchange in a gloo world of 4 ranks ---------------------------------

@pytest.mark.parametrize("name", sorted(AGG))
def test_hier_aggregate_matches_jax_and_oracle(world, name):
    case = AGG[name]
    sg, H, D = case["sg"], case["H"], case["D"]
    ref, ref_g = jax_run(case, jax_hier_aggregate)
    got = port_result(world, name)
    tol = 1e-5 if H == 1 else 1e-4
    np.testing.assert_allclose(got["out"], ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(got["grad"], ref_g, rtol=tol, atol=tol)
    gs, gr, gw = global_edges(sg)
    oracle = hier_oracle_features(sg.x.reshape(-1, sg.x.shape[-1]), gs, gr,
                                  gw, H, D, sg.nodes_per_shard,
                                  case["cluster_of"])
    np.testing.assert_allclose(got["out"], oracle, rtol=tol, atol=tol)
    # shard p's gradient holds the other shards' losses: a detached halo
    # or summary would leave it at the rank-local part alone
    assert np.abs(got["grad"]).sum() > 0


@pytest.mark.parametrize("name", sorted(ATT))
def test_hier_attention_matches_jax(world, name, monkeypatch):
    case = ATT[name]
    exact = case["env"]["FITGNN_GAT_GLOBAL_MAX"] == "0"
    monkeypatch.setattr(jax_tile_gat, "_GLOBAL_MAX", not exact)
    a_src, a_dst = jnp.asarray(case["a_src"]), jnp.asarray(case["a_dst"])
    ref, ref_g = jax_run(case, lambda h, pb: jax_hier_att(h, pb, a_src,
                                                          a_dst, 0.2))
    got = port_result(world, name)
    assert np.isfinite(got["out"]).all() and np.isfinite(got["grad"]).all()
    np.testing.assert_allclose(got["out"], ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["grad"], ref_g, rtol=1e-4, atol=1e-4)


# ---- tile_gat_attention's partials on one process ----------------------------

@pytest.mark.parametrize("exact", [False, True], ids=["global", "exact"])
def test_tile_gat_partials_match_jax(exact, monkeypatch):
    """``(num, den, m)`` before normalization with an external bound and
    row max, and the gradients of a probe of num and den in h and both
    score vectors."""
    monkeypatch.setattr(jax_tile_gat, "_GLOBAL_MAX", not exact)
    monkeypatch.setenv("FITGNN_GAT_GLOBAL_MAX", "0" if exact else "1")
    rng = np.random.default_rng(8)
    n, e, f = 256, 3000, 12
    r = np.sort(rng.integers(0, n, e))
    s = np.where(rng.random(e) < 0.8, (r // 128) * 128
                 + rng.integers(0, 128, e), rng.integers(0, n, e))
    w = np.ones(e, np.float32)
    kw = dict(min_block_edges=16, semantics="att_unit")
    hyb = build_hybrid(s, r, w, n, build_dyn=False, **kw)
    jhyb = jax_build_hybrid(s, r, w, n, build_dyn=False, **kw)
    assert hyb.bsr is not None and hyb.dyn_plan is None
    h = rng.standard_normal((n, f)).astype(np.float32)
    ss = rng.standard_normal(n).astype(np.float32)
    sd = rng.standard_normal(n).astype(np.float32)
    ext = np.where(rng.random(n) < 0.5, rng.standard_normal(n) + 2.0,
                   -1e30).astype(np.float32)
    bound = float(ss.max()) + 0.5
    pr = rng.standard_normal((n, f + 1)).astype(np.float32)

    def probe(num, den, pr):
        return (num * pr[:, :f]).sum() + (den * pr[:, f]).sum()

    th, tss, tsd = (torch.from_numpy(a).requires_grad_() for a in (h, ss,
                                                                     sd))
    num, den, m = tile_gat_attention(hyb, tss, tsd, th, 0.2,
                                     partials=True, src_score_bound=bound,
                                     extra_rowmax=torch.from_numpy(ext))
    probe(num, den, torch.from_numpy(pr)).backward()

    def jfn(hh, a, b):
        return jax_tile_gat.tile_gat_attention(
            jhyb, a, b, hh, 0.2, partials=True,
            src_score_bound=jnp.float32(bound),
            extra_rowmax=jnp.asarray(ext))

    @jax.jit
    def jrun(*a):
        return jfn(*a), jax.grad(lambda *b: probe(*jfn(*b)[:2],
                                                   jnp.asarray(pr)),
                                 argnums=(0, 1, 2))(*a)

    (jnum, jden, jm), grads = jrun(jnp.asarray(h), jnp.asarray(ss),
                                   jnp.asarray(sd))
    for got, ref in ((num, jnum), (den, jden), (m, jm), (th.grad, grads[0]),
                     (tss.grad, grads[1]), (tsd.grad, grads[2])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()))
    if not exact:
        # the global bound is the caller's, not max(score_src)
        np.testing.assert_allclose(m.numpy(), np.maximum(sd + bound, 0.0),
                                   rtol=1e-6)
    else:
        assert (m.numpy() >= ext).all()
