"""The port's raw-format dataset loaders against the JAX package's, on
small files each test writes from a seed (``torch_port_raw_files.py``):
Planetoid (cora, and citeseer's gaps in the test ids), WikipediaNetwork,
TU (attributes, label one-hots, ones), WikiCS, the GNN-benchmark npz (CSR
and dense features, the first ``.npz`` as fallback), GraphSAINT (single-
and multi-label), QM9's sdf (an unreadable atom line and counts line
skipped with their target rows), OGB (node features with the first split
directory, the proteins edge-feature mean, the species one-hot) and ZINC's
pickles (dense bonds and edge lists, the 4,000-a-part subset).  Every
array equal, dtypes too, and both registries' routing, including
flickr's GraphSAINT → npz fallback."""

import gzip
import os

import numpy as np
import pytest
import torch

from fitgnn_tpu.data import datasets as jax_ds

from fitgnn_tpu_torch.data import datasets as ds
from fitgnn_tpu_torch.data.datasets import DatasetNotFoundError

import torch_port_raw_files as raw

torch.set_num_threads(1)

NODE_FIELDS = ("x", "senders", "receivers", "y", "train_mask", "val_mask",
               "test_mask")


def same_node(got, ref):
    assert got.name == ref.name
    for f in NODE_FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        if b is None:
            assert a is None, f
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


def same_graphs(got, ref):
    assert got.name == ref.name and len(got.graphs) == len(ref.graphs)
    for g, h in zip(got.graphs, ref.graphs):
        for a, b in zip(g, h):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got.y.dtype == ref.y.dtype
    np.testing.assert_array_equal(got.y, ref.y)


# each case: (writer calls, the loader's name, its arguments)
NODE_CASES = {
    "planetoid_cora": ([(raw.write_planetoid, dict(name="cora"))],
                       "load_planetoid", ("cora",)),
    "planetoid_citeseer_gaps": (
        [(raw.write_planetoid, dict(name="citeseer", gaps=True))],
        "load_planetoid", ("citeseer",)),
    "wikipedia": ([(raw.write_wikipedia, {})], "load_wikipedia_network",
                  ("chameleon",)),
    "wikics": ([(raw.write_wikics, {})], "load_wikics", ()),
    "npz_csr": ([(raw.write_attributed_npz, {})], "load_attributed_npz",
                ("physics",)),
    "npz_dense_first_file": (
        [(raw.write_attributed_npz, dict(name="dblp", dense=True,
                                         file="coauthor.npz"))],
        "load_attributed_npz", ("dblp",)),
    "graphsaint": ([(raw.write_graphsaint, {})], "load_graphsaint",
                   ("flickr",)),
    "graphsaint_multilabel": (
        [(raw.write_graphsaint, dict(name="yelp", multilabel=True))],
        "load_graphsaint", ("yelp",)),
    "ogbn_feat_splits": ([(raw.write_ogbn, {})], "load_ogbn",
                         ("ogbn-arxiv",)),
    "ogbn_edge_feat": ([(raw.write_ogbn, dict(name="ogbn-proteins",
                                              mode="edge_feat"))],
                       "load_ogbn", ("ogbn-proteins",)),
    "ogbn_species": ([(raw.write_ogbn, dict(name="ogbn-proteins",
                                            mode="species"))],
                     "load_ogbn", ("ogbn-proteins",)),
}


@pytest.mark.parametrize("case", sorted(NODE_CASES))
def test_node_loader_matches_jax(case, tmp_path):
    writers, loader, args = NODE_CASES[case]
    for w, kw in writers:
        w(str(tmp_path), **kw)
    got = getattr(ds, loader)(str(tmp_path), *args)
    same_node(got, getattr(jax_ds, loader)(str(tmp_path), *args))
    assert got.num_nodes > 0


GRAPH_CASES = {
    "tu_labels": (raw.write_tu, dict(name="PROTEINS"), "load_tu_dataset",
                  ("PROTEINS",)),
    "tu_attributes": (raw.write_tu, dict(name="ENZYMES",
                                         features="attributes"),
                      "load_tu_dataset", ("ENZYMES",)),
    "tu_ones": (raw.write_tu, dict(name="AIDS", features="none"),
                "load_tu_dataset", ("AIDS",)),
    "qm9": (raw.write_qm9, {}, "load_qm9_sdf", ()),
    "zinc_full": (raw.write_zinc, {}, "load_zinc_pickle",
                  ("ZINC", False)),
    "zinc_subset": (raw.write_zinc, {}, "load_zinc_pickle",
                    ("ZINC", True)),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_loader_matches_jax(case, tmp_path):
    writer, kw, loader, args = GRAPH_CASES[case]
    writer(str(tmp_path), **kw)
    got = getattr(ds, loader)(str(tmp_path), *args)
    same_graphs(got, getattr(jax_ds, loader)(str(tmp_path), *args))
    if case == "qm9":         # blocks 1 and 3 are skipped with their rows
        assert len(got.graphs) == 3 and got.y.shape == (3, 19)
    if case.startswith("zinc"):
        assert len(got.graphs) == (4000 if args[1] else 4003) + 5 + 4


def test_qm9_max_molecules(tmp_path):
    raw.write_qm9(str(tmp_path))
    got = ds.load_qm9_sdf(str(tmp_path), max_molecules=3)
    same_graphs(got, jax_ds.load_qm9_sdf(str(tmp_path), max_molecules=3))
    assert len(got.graphs) == 2


def test_read_csv_gz_matches_pandas(tmp_path):
    """The port's numpy reader against the JAX package's pandas one on
    floats in every written form (at float32, the type every loader reads
    floats in), ints, a one-column file and CRLF.  At float64 the port's
    parse is Python's correctly rounded one; pandas' default parser is
    not (it differs in the last bit on about one field in eight here),
    which the cast to float32 absorbs."""
    rng = np.random.default_rng(9)
    path = str(tmp_path / "f.csv.gz")
    texts = np.array(raw.float_texts(rng, 4000)).reshape(800, 5)
    raw._gz(path, texts.tolist())
    got = ds._read_csv_gz(path, np.float32)
    ref = jax_ds._read_csv_gz(path, np.float32)
    assert got.dtype == ref.dtype == np.float32 and got.shape == (800, 5)
    np.testing.assert_array_equal(got, ref)
    assert np.signbit(got[0, 0]) and got[0, 0] == 0.0
    exact = np.vectorize(float)(texts)
    np.testing.assert_array_equal(ds._read_csv_gz(path, np.float64), exact)
    ints = rng.integers(-2 ** 40, 2 ** 40, (50, 3))
    raw._gz(path, ints.tolist())
    np.testing.assert_array_equal(ds._read_csv_gz(path, np.int64), ints)
    np.testing.assert_array_equal(ds._read_csv_gz(path, np.int64),
                                  jax_ds._read_csv_gz(path, np.int64))
    with gzip.open(path, "wt", newline="") as fo:
        fo.write("3\r\n1\r\n2\r\n")
    np.testing.assert_array_equal(ds._read_csv_gz(path, np.int64),
                                  jax_ds._read_csv_gz(path, np.int64))
    with gzip.open(path, "wt") as fo:
        fo.write("1,2\n3,x\n")
    with pytest.raises(ValueError, match="expected 2 rows of 2"):
        ds._read_csv_gz(path, np.float32)


def test_node_registry_routes_as_jax(tmp_path):
    root = str(tmp_path)
    raw.write_planetoid(root, name="pubmed")
    raw.write_wikipedia(root, name="squirrel")
    raw.write_wikics(root)
    raw.write_attributed_npz(root, name="physics")
    raw.write_ogbn(root, name="ogbn-products")
    for name in ("pubmed", "squirrel", "wikics", "Physics",
                 "ogbn-products"):
        got = ds.load_node_dataset(name, root)
        same_node(got, jax_ds.load_node_dataset(name, root))
    # flickr: GraphSAINT first, the GNN-benchmark npz when it is absent
    raw.write_attributed_npz(root, name="flickr")
    same_node(ds.load_node_dataset("flickr", root),
              ds.load_attributed_npz(root, "flickr"))
    raw.write_graphsaint(root, name="flickr")
    same_node(ds.load_node_dataset("flickr", root),
              jax_ds.load_node_dataset("flickr", root))
    assert ds.load_node_dataset("flickr", root).test_mask.sum() == 2
    # the npz cache wins over the raw files
    cora = ds.load_node_dataset("pubmed", root)
    ds.save_npz_cache(os.path.join(root, "pubmed", "pubmed.npz"),
                      ds.NodeDataset("pubmed", cora.x[:3], cora.senders[:1],
                                     cora.receivers[:1], cora.y[:3]))
    assert ds.load_node_dataset("pubmed", root).num_nodes == 3
    for name in ("cora", "crocodile", "ogbn-arxiv", "dblp", "flickr2"):
        with pytest.raises(DatasetNotFoundError):
            ds.load_node_dataset(name, str(tmp_path / "empty"))


def test_graph_registry_routes_as_jax(tmp_path):
    root = str(tmp_path)
    raw.write_tu(root, name="ENZYMES", features="attributes")
    raw.write_qm9(root)
    raw.write_zinc(root, big=7)
    for name in ("ENZYMES", "QM9", "ZINC", "ZINC_subset"):
        same_graphs(ds.load_graph_dataset(name, root),
                    jax_ds.load_graph_dataset(name, root))
    for name in ("PROTEINS", "QM9", "ZINC", "nope"):
        with pytest.raises(DatasetNotFoundError):
            ds.load_graph_dataset(name, str(tmp_path / "empty"))
