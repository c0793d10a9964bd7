"""The port's partition pipeline, its artifact cache, ``optimize_coarse``
and the batched layers against the JAX package, on the CPU.

The partition is host numpy in both packages, so every array must be
equal: ``parent``, Gc's arrays and each ``SubgraphBatch`` field.  The
batched (S, N, F) layers are held against the JAX package's ``jax.vmap``
of its layers and against the port's own layers one subgraph at a time,
within rtol 1e-4 and atol 1e-5·max(1, max|ref|).
"""

import importlib
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from fitgnn_tpu.cli import main as jax_cli
from fitgnn_tpu.data.datasets import load_node_dataset as jax_load
from fitgnn_tpu.graph.container import Graph as JaxGraph
from fitgnn_tpu.graph.optimize import optimize_coarse as jax_optimize_coarse
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.partition import coarsen_and_partition as jax_partition
from fitgnn_tpu.utils.cache import ArtifactCache as JaxCache

from fitgnn_tpu_torch.cli import main as port_cli
from fitgnn_tpu_torch.data.datasets import load_node_dataset
from fitgnn_tpu_torch.graph.container import Graph, SubgraphBatch
from fitgnn_tpu_torch.graph.optimize import optimize_coarse
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.ops.spmm import spmm_coo
from fitgnn_tpu_torch.partition.pipeline import (CoarseData,
                                                 PartitionedDataset,
                                                 coarsen_and_partition)
from fitgnn_tpu_torch.utils.cache import (ARTIFACT_KIND, ArtifactCache,
                                          content_key)

torch.set_num_threads(1)


def close(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


def node_data(n=320, feat=6, classes=4, seed=0, regression=False):
    rng = np.random.default_rng(seed)
    e = n * 4
    r = rng.integers(0, n, e)
    s = np.where(rng.random(e) < 0.8,
                 np.minimum((r // 40) * 40 + rng.integers(0, 40, e), n - 1),
                 rng.integers(0, n, e))
    keep = s != r
    s, r = s[keep], r[keep]
    x = rng.standard_normal((n, feat)).astype(np.float32)
    y = (rng.standard_normal(n).astype(np.float32) if regression
         else ((np.arange(n) // 40) % classes).astype(np.int64))
    tr = rng.random(n) < 0.4
    va = ~tr & (rng.random(n) < 0.3)
    te = ~tr & ~va
    return x, s, r, y, tr, va, te


def assert_partitions_equal(got, ref):
    np.testing.assert_array_equal(got.parent, ref.parent)
    assert got.num_metanodes == ref.num_metanodes
    assert set(got.subgraphs._fields) == set(ref.subgraphs._fields)
    for f in ref.subgraphs._fields:
        a, b = getattr(got.subgraphs, f), getattr(ref.subgraphs, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert isinstance(a, torch.Tensor), f
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), f)
    for f in ("y_train", "train_mask", "y_val", "val_mask"):
        np.testing.assert_array_equal(getattr(got.coarse, f).numpy(),
                                      np.asarray(getattr(ref.coarse, f)), f)
    for f in ("x", "senders", "receivers", "edge_weight", "n_node",
              "n_edge"):
        np.testing.assert_array_equal(
            getattr(got.coarse.graph, f).numpy(),
            np.asarray(getattr(ref.coarse.graph, f)), f)


@pytest.mark.parametrize("mode", ["plain", "extra_node", "cluster_node"])
def test_coarsen_and_partition_matches_jax(mode):
    x, s, r, y, tr, va, te = node_data()
    kw = dict(mode=mode, num_classes=4, train_mask=tr, val_mask=va,
              test_mask=te)
    got = coarsen_and_partition(x, s, r, y, **kw)
    ref = jax_partition(x, s, r, y, **kw)
    assert_partitions_equal(got, ref)
    assert got.subgraphs.num_subgraphs == got.num_metanodes


@pytest.mark.parametrize("method", ["heavy_edge", "kron"])
def test_coarsen_and_partition_regression_matches_jax(method):
    x, s, r, y, tr, va, te = node_data(seed=1, regression=True)
    kw = dict(task="regression", method=method, reduction=0.6,
              train_mask=tr, val_mask=va, test_mask=te)
    assert_partitions_equal(coarsen_and_partition(x, s, r, y, **kw),
                            jax_partition(x, s, r, y, **kw))


def test_bucketed_partition_raises():
    """A negative bucket cap raises in both packages."""
    x, s, r, y, tr, va, te = node_data(n=80)
    for partition in (coarsen_and_partition, jax_partition):
        with pytest.raises(ValueError, match="max_buckets"):
            partition(x, s, r, y, num_classes=4, bucket=True,
                      max_buckets=-1)


@pytest.mark.parametrize("layer", ["GCNConv", "GATConv"])
def test_optimize_coarse_matches_jax(layer):
    """The same Leiden order, tiles and stragglers on a small Gc."""
    x, s, r, y, tr, va, te = node_data(n=3_000, seed=2)
    kw = dict(num_classes=4, train_mask=tr, val_mask=va, test_mask=te)
    got = optimize_coarse(coarsen_and_partition(x, s, r, y, **kw).coarse,
                          min_block_edges=24, layer_name=layer, seed=0)
    ref = jax_optimize_coarse(jax_partition(x, s, r, y, **kw).coarse,
                              min_block_edges=24, layer_name=layer, seed=0)
    for f in ("x", "senders", "receivers", "edge_weight"):
        np.testing.assert_array_equal(getattr(got.graph, f).numpy(),
                                      np.asarray(getattr(ref.graph, f)), f)
    for f in ("y_train", "train_mask", "y_val", "val_mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    ht, hj = got.graph.aux, ref.graph.aux
    assert ht.semantics == hj.semantics
    assert ht.bsr.nnz_blocks == hj.bsr.nnz_blocks > 0
    assert ht.num_coo_edges == hj.num_coo_edges > 1
    for f in ("rows", "cols", "blocks"):
        np.testing.assert_array_equal(getattr(ht.bsr, f).numpy(),
                                      np.asarray(getattr(hj.bsr, f)), f)
    assert got.graph.num_nodes_padded % 128 == 0


def test_random_ring_matches_jax():
    got, ref = load_node_dataset("random_300"), jax_load("random_300")
    for f in ("x", "senders", "receivers", "y"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert got.num_nodes == 300 and got.train_mask is None


def small_batch(seed=3, mode="plain"):
    x, s, r, y, tr, va, te = node_data(n=200, seed=seed)
    kw = dict(mode=mode, num_classes=4, train_mask=tr, val_mask=va,
              test_mask=te)
    return (coarsen_and_partition(x, s, r, y, **kw),
            jax_partition(x, s, r, y, **kw))


def test_subgraph_batch_views():
    part, _ = small_batch()
    b = part.subgraphs
    g = b.subgraph(3)
    assert isinstance(g, Graph) and g.num_nodes_padded == b.num_nodes_padded
    assert g.x.data_ptr() == b.x[3].data_ptr()
    assert int(g.n_edge) == int(b.n_edge[3])
    assert g.edge_mask.shape == (b.senders.shape[1],)
    stack = b.graphs()
    assert stack.num_nodes_padded == b.num_nodes_padded == b.x.shape[1]
    assert stack.edge_mask.shape == b.senders.shape
    np.testing.assert_array_equal(stack.edge_mask[3].numpy(),
                                  g.edge_mask.numpy())
    sl = b.slice(2, 5)
    assert sl.num_subgraphs == 3 and sl.train_mask.shape[0] == 3
    assert b.to("cpu").x.shape == b.x.shape


@pytest.mark.parametrize("dense", [True, False])
def test_batched_spmm_matches_per_subgraph(monkeypatch, dense):
    part, _ = small_batch(mode="extra_node")
    b = part.subgraphs
    if not dense:
        monkeypatch.setattr("fitgnn_tpu_torch.ops.spmm.DENSE_SPMM_MAX_N", 4)
    n = b.num_nodes_padded
    out = spmm_coo(b.edge_weight, b.senders, b.receivers, b.x, n)
    for i in (0, 7, b.num_subgraphs - 1):
        g = b.subgraph(i)
        close(out[i], spmm_coo(g.edge_weight, g.senders, g.receivers, g.x, n))


@pytest.mark.parametrize("layer", ["GCNConv", "GATConv"])
@pytest.mark.parametrize("dense", [True, False])
def test_batched_model_matches_jax_vmap(monkeypatch, layer, dense):
    """The stacked forward against the JAX package's vmap of its model,
    and against the port's model one subgraph at a time."""
    part, jpart = small_batch(mode="cluster_node")
    b, jb = part.subgraphs, jpart.subgraphs
    if not dense:
        monkeypatch.setattr("fitgnn_tpu_torch.ops.spmm.DENSE_SPMM_MAX_N", 4)
        monkeypatch.setattr(importlib.import_module("fitgnn_tpu.ops.spmm"),
                            "DENSE_SPMM_MAX_N", 4)
    jm = JaxNodeModel(layer_name=layer, hidden=16, num_layers=2, out_dim=4)
    g0 = jb.subgraph(0)
    params = jm.init(jax.random.PRNGKey(0), g0.x, g0)
    gj = JaxGraph(x=jb.x, senders=jb.senders, receivers=jb.receivers,
                  edge_weight=jb.edge_weight, n_node=jb.n_node,
                  n_edge=jb.n_edge)
    ref = jax.vmap(lambda xx, gg: jm.apply(params, xx, gg))(jb.x, gj)
    model = NodeModel(layer, 6, 16, 2, 4)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    with torch.no_grad():
        out = model(b.x, b.graphs())
        close(out, ref)
        for i in (0, b.num_subgraphs // 2):
            g = b.subgraph(i)
            close(out[i], model(g.x, g).numpy())


def test_artifact_cache_roundtrip_and_refusal(tmp_path):
    part, jpart = small_batch()
    cache = ArtifactCache(str(tmp_path / ARTIFACT_KIND))
    cache.save("k", part)
    with open(tmp_path / ARTIFACT_KIND / "k.pkl", "rb") as f:
        raw = f.read()
    assert b"fitgnn_tpu." not in raw and b"torch" not in raw.split(
        b"fitgnn_tpu_torch")[0]
    back = cache.load("k")
    assert isinstance(back, PartitionedDataset)
    assert isinstance(back.coarse, CoarseData)
    assert isinstance(back.subgraphs, SubgraphBatch)
    assert_partitions_equal(back, jpart)
    assert cache.load_or_compute("k", lambda: 1 / 0)[1] is True
    # an artifact of the JAX package is never unpickled
    JaxCache(str(tmp_path / ARTIFACT_KIND)).save("jax", jpart)
    with pytest.raises(pickle.UnpicklingError, match="fitgnn_tpu"):
        cache.load("jax")


def test_cli_partition_keys_and_places_apart_from_jax(tmp_path, monkeypatch):
    """The port's ``_partition`` and the JAX package's, on the same
    arguments, write different keys into different directories; the
    second port call hits its own cache."""
    monkeypatch.chdir(tmp_path)
    argv = ["train", "--dataset", "random_200", "--data_root",
            str(tmp_path / "dataset"), "--experiment", "random"]
    pa = port_cli.arg_correction(port_cli.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    ja = jax_cli.arg_correction(jax_cli.build_parser().parse_args(argv))
    ds = load_node_dataset("random_200")
    masks = port_cli._splits(pa, ds, ds.num_classes)
    got = port_cli._partition(pa, ds, *masks, ds.num_classes)
    ref = jax_cli._partition(ja, jax_load("random_200"), *masks,
                             ds.num_classes)
    assert_partitions_equal(got, ref)
    saved = tmp_path / "dataset" / "random_200" / "saved"
    port_files = os.listdir(saved / ARTIFACT_KIND)
    jax_files = [f for f in os.listdir(saved) if f.endswith(".pkl")]
    assert len(port_files) == 1 and len(jax_files) == 1
    assert port_files[0] != jax_files[0]
    again = port_cli._partition(pa, ds, *masks, ds.num_classes)
    np.testing.assert_array_equal(again.parent, got.parent)
    assert content_key({"a": np.zeros(3)}, {"k": 1}) != content_key(
        {"a": np.zeros(3)}, {"k": 1, "artifact": ARTIFACT_KIND})
