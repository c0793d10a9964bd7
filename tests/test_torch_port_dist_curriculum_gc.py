"""The distributed curriculum's Gc phase (``train/loop.py``
``hier_gc_plan`` and ``_make_hier_gc_steps``) against the JAX package's
``_make_hier_gc_steps``, on the CPU.

On the coarse graph of the SBM partition (151 nodes, classification; the
regression graph's for regression), the host side exactly: Leiden's
placement order, the sharded graph's arrays, the (shard, community)
clusters and the interior collapse's cluster size snapped from
``gc_cluster=384`` with the JAX package's warning, read from the JAX
function's calls to ``placement_by_community`` and ``build_hier_plan``.
Then the val eval's (loss, metric) from the same parameters (the JAX
package's ``NodeModel`` init, dropout 0): GCN, SAGE, GIN and GAT on one
host of four chips, (H, D) = (1, 4), GCN at (2, 2) for classification,
with the collapse and for regression; the JAX side here on 4 of the host
devices ``conftest.py`` forces, the port's in one gloo world of 4 ranks
(``torch_port_dist_worker.py``), started first.  Tolerance: rtol 1e-4,
atol 1e-4·max|ref|.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import fitgnn_tpu.parallel as jax_parallel
import fitgnn_tpu.parallel.multihost as jax_multihost
from fitgnn_tpu.train import NodeTaskConfig as JaxConfig
from fitgnn_tpu.train.loop import _make_hier_gc_steps as jax_hier_gc_steps

from fitgnn_tpu_torch.train import loop

from torch_port_dist_curriculum_cases import (HIDDEN, close, jax_params,
                                              out_dim, partitions,
                                              port_params)
from torch_port_dist_worker import World

torch.set_num_threads(1)

# (layer, task, H, D, gc_cluster)
EVALS = [("GCNConv", "classification", 1, 4, 0),
         ("SAGEConv", "classification", 1, 4, 0),
         ("GINConv", "classification", 1, 4, 0),
         ("GATConv", "classification", 1, 4, 0),
         ("GCNConv", "classification", 2, 2, 0),
         ("GCNConv", "classification", 2, 2, 384),
         ("GCNConv", "regression", 2, 2, 0)]


def name_of(case):
    layer, task, H, D, k = case
    return f"{layer}_{task[:3]}_{H}x{D}" + (f"_k{k}" if k else "")


def config(layer, task, H, D, k) -> dict:
    return dict(layer_name=layer, hidden=HIDDEN, num_layers=2, task=task,
                out_dim=out_dim(task), num_devices=H * D, num_hosts=H,
                gc_cluster=k, seed=0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = []
    for case in EVALS:
        layer, task = case[:2]
        part, _ = partitions(task)
        cases.append((name_of(case), dict(
            kind="gc_eval", cfg=config(*case), coarse=part.coarse,
            layer=layer, task=task, in_dim=part.coarse.graph.x.shape[-1],
            hidden=HIDDEN, out_dim=out_dim(task),
            params=port_params(jax_params(layer, task).params))))
    w = World(cases, tmp_path_factory.mktemp("dist_gc"))
    yield w
    w.wait()


def jax_host_side(cfg, coarse):
    """The JAX package's ``_make_hier_gc_steps`` on ``cfg`` and its
    placement order and ``build_hier_plan`` arguments."""
    seen = {}
    place, build = (jax_multihost.placement_by_community,
                    jax_parallel.build_hier_plan)

    def placement(*a, **k):
        seen["order"] = place(*a, **k)[0]
        return seen["order"], None

    def plan(*a, **k):
        seen["args"], seen["kwargs"] = a, k
        return build(*a, **k)

    with mock.patch.object(jax_multihost, "placement_by_community",
                           placement), \
            mock.patch.object(jax_parallel, "build_hier_plan", plan):
        fns = jax_hier_gc_steps(JaxConfig(**cfg), coarse)
    return fns, seen


@pytest.mark.parametrize("H,D", [(1, 4), (2, 2)])
def test_hier_gc_plan_matches_jax(H, D, capsys):
    part, jpart = partitions("classification")
    cfg = config("GCNConv", "classification", H, D, 384)
    _, seen = jax_host_side(cfg, jpart.coarse)
    ref_warning = capsys.readouterr().out
    hg = loop.hier_gc_plan(loop.NodeTaskConfig(**cfg, device="cpu"),
                           part.coarse)
    assert capsys.readouterr().out == ref_warning
    assert ref_warning == ("warning: interior cluster size 384 does not "
                           "divide the per-shard padded node count 128; "
                           "using 128\n")
    np.testing.assert_array_equal(hg.order, seen["order"])
    s, r, w, h, d, n_loc, cluster_of = seen["args"]
    assert (h, d, n_loc) == (H, D, hg.sg.nodes_per_shard)
    np.testing.assert_array_equal(hg.cluster_of, cluster_of)
    for got, ref in ((hg.sg.senders, s), (hg.sg.receivers, r),
                     (hg.sg.edge_weight, w)):
        np.testing.assert_array_equal(got, ref)
    assert hg.cluster_size == seen["kwargs"]["interior_cluster"] == 128
    assert hg.plan.interior["cluster_agg"] == 128


@pytest.mark.parametrize("case", EVALS, ids=name_of)
def test_hier_gc_eval_matches_jax(world, case):
    layer, task = case[:2]
    _, jpart = partitions(task)
    (_, val_fn), _ = jax_host_side(config(*case), jpart.coarse)
    ref = [float(v) for v in val_fn(jax_params(layer, task))]
    for r in world.results(name_of(case)):
        close(r["eval"], ref, name_of(case))
