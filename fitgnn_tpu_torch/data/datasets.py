"""Datasets: the standardized npz caches and the raw formats the JAX
package's loaders read, giving the same arrays.

A node-task dataset lives at ``<root>/<name>/<name>.npz`` with arrays
``x``, ``senders``, ``receivers``, ``y`` and optional ``train_mask``,
``val_mask``, ``test_mask`` — the JAX package's cache format, written by
``save_npz_cache``.  ``random`` / ``random_<N>`` is the synthetic ring,
made on the fly.  A graph-level dataset lives at
``<root>/<name>/<name>_graphs.npz``: an object array ``graphs`` of
``(x, senders, receivers)`` and the targets ``y`` (``save_graph_cache``).

Without a cache the registries read the raw files a user places under
``<root>/<name>/raw`` (nothing is downloaded):

* node classification — cora, citeseer, pubmed (Planetoid ``ind.*``
  pickles), dblp, physics (GNN-benchmark npz), wikics (``data.json``),
  ogbn-arxiv / products / proteins (OGB ``*.csv.gz``), flickr
  (GraphSAINT, else GNN-benchmark npz);
* node regression — chameleon, squirrel, crocodile (geom-gcn text);
* graph classification — ENZYMES, PROTEINS, AIDS (TU text);
* graph regression — QM9 (``gdb9.sdf`` + csv), ZINC and ZINC_subset
  (benchmarking-gnns pickles).

Pickled files (Planetoid's, ZINC's, the graph caches) can run code when
loaded: load only files from a source you trust.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import pickle
import warnings
from typing import List, Optional, Tuple

import numpy as np

NODE_CLS = ("cora", "citeseer", "pubmed", "dblp", "physics", "wikics",
            "ogbn-arxiv", "ogbn-products", "ogbn-proteins", "flickr")
NODE_REG = ("chameleon", "squirrel", "crocodile")
GRAPH_CLS = ("ENZYMES", "PROTEINS", "AIDS")
GRAPH_REG = ("QM9", "ZINC", "ZINC_subset")

# the dataset name → task map of the JAX package's ``TASK_OF``
TASK_OF = {**{d: "node_cls" for d in NODE_CLS},
           **{d: "node_reg" for d in NODE_REG},
           **{d: "graph_cls" for d in GRAPH_CLS},
           **{d: "graph_reg" for d in GRAPH_REG}}


@dataclasses.dataclass
class NodeDataset:
    name: str
    x: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    y: np.ndarray
    train_mask: Optional[np.ndarray] = None
    val_mask: Optional[np.ndarray] = None
    test_mask: Optional[np.ndarray] = None

    @property
    def num_nodes(self):
        return self.x.shape[0]

    @property
    def num_classes(self):
        return int(self.y.max()) + 1 if np.issubdtype(self.y.dtype,
                                                      np.integer) else 0


@dataclasses.dataclass
class GraphDataset:
    name: str
    graphs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]  # (x, s, r)
    y: np.ndarray                       # (B,) labels or (B, T) targets


class DatasetNotFoundError(FileNotFoundError):
    pass


def _missing(name: str, root: str, expected: str) -> DatasetNotFoundError:
    return DatasetNotFoundError(
        f"dataset {name!r} not found under {root!r}: expected {expected}. "
        f"Place the raw files or an npz cache there (see "
        f"save_npz_cache/load_npz_cache); nothing is downloaded.")


def save_npz_cache(path: str, ds: NodeDataset) -> None:
    arrays = dict(x=ds.x, senders=ds.senders, receivers=ds.receivers, y=ds.y)
    for k in ("train_mask", "val_mask", "test_mask"):
        v = getattr(ds, k)
        if v is not None:
            arrays[k] = v
    np.savez_compressed(path, **arrays)


def load_npz_cache(path: str, name: str) -> NodeDataset:
    with np.load(path) as z:
        return NodeDataset(
            name=name, x=z["x"], senders=z["senders"],
            receivers=z["receivers"], y=z["y"],
            train_mask=z["train_mask"] if "train_mask" in z else None,
            val_mask=z["val_mask"] if "val_mask" in z else None,
            test_mask=z["test_mask"] if "test_mask" in z else None)


# ---------------------------------------------------------------------------
# Planetoid raw format (cora / citeseer / pubmed)
# ---------------------------------------------------------------------------

def _parse_index_file(path: str) -> np.ndarray:
    with open(path) as f:
        return np.array([int(line.strip()) for line in f], dtype=np.int64)


def load_planetoid(root: str, name: str) -> NodeDataset:
    """Parse the ``ind.<name>.{x,tx,allx,y,ty,ally,graph,test.index}``
    pickles (the format PyG's Planetoid consumes)."""
    raw = os.path.join(root, name, "raw")
    names = ["x", "y", "tx", "ty", "allx", "ally", "graph"]
    paths = [os.path.join(raw, f"ind.{name.lower()}.{n}") for n in names]
    idx_path = os.path.join(raw, f"ind.{name.lower()}.test.index")
    if not all(os.path.exists(p) for p in paths + [idx_path]):
        raise _missing(name, raw, "Planetoid ind.* files")

    objs = []
    for p in paths:
        with open(p, "rb") as f:
            objs.append(pickle.load(f, encoding="latin1"))
    x, y, tx, ty, allx, ally, graph = objs
    test_idx = _parse_index_file(idx_path)
    test_sorted = np.sort(test_idx)

    import scipy.sparse as sp
    allx = sp.csr_matrix(allx)
    tx = sp.csr_matrix(tx)
    if name.lower() == "citeseer":
        # citeseer's test ids have gaps (isolated nodes absent from tx):
        # scatter tx/ty into the full contiguous range, zeros elsewhere
        full = np.arange(test_sorted.min(), test_sorted.max() + 1)
        tx_ext = sp.lil_matrix((len(full), tx.shape[1]))
        tx_ext[test_sorted - test_sorted.min()] = tx
        ty_ext = np.zeros((len(full), ty.shape[1]))
        ty_ext[test_sorted - test_sorted.min()] = ty
        tx, ty = sp.csr_matrix(tx_ext), ty_ext

    # vstack puts test rows (file order) at the tail block, which coincides
    # with the sorted test id range; permute them into true id positions
    features = sp.vstack([allx, tx]).tolil()
    features[test_idx] = features[test_sorted]
    labels_oh = np.vstack([ally, ty])
    labels_oh[test_idx] = labels_oh[test_sorted]
    labels = labels_oh.argmax(axis=1).astype(np.int64)

    n = features.shape[0]
    senders, receivers = [], []
    for u, nbrs in graph.items():
        for v in nbrs:
            if u != v and u < n and v < n:
                senders.append(u)
                receivers.append(v)
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)

    train_mask = np.zeros(n, dtype=bool)
    val_mask = np.zeros(n, dtype=bool)
    test_mask = np.zeros(n, dtype=bool)
    train_mask[: y.shape[0]] = True
    val_mask[y.shape[0]: y.shape[0] + 500] = True
    test_mask[test_idx] = True

    return NodeDataset(
        name=name, x=np.asarray(features.todense(), dtype=np.float32),
        senders=senders, receivers=receivers, y=labels,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask)


# ---------------------------------------------------------------------------
# WikipediaNetwork raw text (chameleon / squirrel / crocodile, geom_gcn=False)
# ---------------------------------------------------------------------------

def load_wikipedia_network(root: str, name: str) -> NodeDataset:
    raw = os.path.join(root, name, "raw")
    feat_path = os.path.join(raw, "out1_node_feature_label.txt")
    edge_path = os.path.join(raw, "out1_graph_edges.txt")
    if not (os.path.exists(feat_path) and os.path.exists(edge_path)):
        raise _missing(name, raw, "geom-gcn out1_*.txt files")
    xs, ys = [], []
    with open(feat_path) as f:
        next(f)  # header
        for line in f:
            _, feat, label = line.strip().split("\t")
            xs.append([float(v) for v in feat.split(",")])
            ys.append(float(label))
    edges = np.loadtxt(edge_path, skiprows=1, dtype=np.int64)
    # node regression target: log(1 + traffic), like the reference datasets
    y = np.log1p(np.asarray(ys, dtype=np.float64)).astype(np.float32)
    return NodeDataset(name=name, x=np.asarray(xs, dtype=np.float32),
                       senders=edges[:, 0], receivers=edges[:, 1], y=y)


# ---------------------------------------------------------------------------
# TU format (ENZYMES / PROTEINS / AIDS)
# ---------------------------------------------------------------------------

def load_tu_dataset(root: str, name: str) -> GraphDataset:
    raw = os.path.join(root, name, "raw")
    pre = os.path.join(raw, name)
    a_path = f"{pre}_A.txt"
    gi_path = f"{pre}_graph_indicator.txt"
    gl_path = f"{pre}_graph_labels.txt"
    if not all(os.path.exists(p) for p in (a_path, gi_path, gl_path)):
        raise _missing(name, raw, "TU DS_A/graph_indicator/graph_labels files")
    edges = np.loadtxt(a_path, delimiter=",", dtype=np.int64) - 1  # 1-based
    gi = np.loadtxt(gi_path, dtype=np.int64) - 1
    gl = np.loadtxt(gl_path, dtype=np.int64)
    gl = gl - gl.min()

    na_path = f"{pre}_node_attributes.txt"
    nl_path = f"{pre}_node_labels.txt"
    if os.path.exists(na_path):
        feats = np.loadtxt(na_path, delimiter=",", dtype=np.float32)
        if feats.ndim == 1:
            feats = feats[:, None]
    elif os.path.exists(nl_path):
        nl = np.loadtxt(nl_path, dtype=np.int64)
        nl = nl - nl.min()
        feats = np.eye(int(nl.max()) + 1, dtype=np.float32)[nl]
    else:
        feats = np.ones((len(gi), 1), dtype=np.float32)

    num_graphs = int(gi.max()) + 1
    node_off = np.zeros(num_graphs + 1, dtype=np.int64)
    counts = np.bincount(gi, minlength=num_graphs)
    node_off[1:] = np.cumsum(counts)
    edge_graph = gi[edges[:, 0]]

    graphs = []
    order = np.argsort(edge_graph, kind="stable")
    edges_sorted = edges[order]
    bounds = np.searchsorted(edge_graph[order], np.arange(num_graphs + 1))
    for g in range(num_graphs):
        lo, hi = node_off[g], node_off[g + 1]
        e = edges_sorted[bounds[g]:bounds[g + 1]] - lo
        graphs.append((feats[lo:hi], e[:, 0].astype(np.int32),
                       e[:, 1].astype(np.int32)))
    return GraphDataset(name=name, graphs=graphs, y=gl)


# ---------------------------------------------------------------------------
# WikiCS json + Coauthor/Attributed-graph npz formats
# ---------------------------------------------------------------------------

def load_wikics(root: str) -> NodeDataset:
    """WikiCS ``data.json``: features, links (adjacency lists), labels, and
    the 20 official split columns (first split used)."""
    path = os.path.join(root, "wikics", "raw", "data.json")
    if not os.path.exists(path):
        raise _missing("wikics", os.path.dirname(path), "data.json")
    with open(path) as f:
        d = json.load(f)
    x = np.asarray(d["features"], dtype=np.float32)
    y = np.asarray(d["labels"], dtype=np.int64)
    senders, receivers = [], []
    for u, nbrs in enumerate(d["links"]):
        for v in nbrs:
            senders.append(u)
            receivers.append(v)
    tm = np.asarray(d["train_masks"], dtype=bool)
    vm = np.asarray(d["val_masks"], dtype=bool)
    test = np.asarray(d["test_mask"], dtype=bool)
    return NodeDataset(
        name="wikics", x=x, senders=np.asarray(senders, np.int64),
        receivers=np.asarray(receivers, np.int64), y=y,
        train_mask=tm[0] if tm.ndim > 1 else tm,
        val_mask=vm[0] if vm.ndim > 1 else vm, test_mask=test)


def load_attributed_npz(root: str, name: str) -> NodeDataset:
    """The GNN-benchmark npz layout used by Coauthor Physics / Amazon /
    (also works for many published .npz graph dumps): CSR adjacency
    (``adj_{data,indices,indptr,shape}``), CSR or dense features
    (``attr_*`` / ``attr_matrix``), ``labels``."""
    path = os.path.join(root, name, "raw", f"{name}.npz")
    if not os.path.exists(path):
        matches = []
        raw = os.path.join(root, name, "raw")
        if os.path.isdir(raw):
            matches = [f for f in os.listdir(raw) if f.endswith(".npz")]
        if matches:
            path = os.path.join(raw, matches[0])
        else:
            raise _missing(name, raw, "GNN-benchmark npz file")
    import scipy.sparse as sp
    with np.load(path, allow_pickle=True) as z:
        adj = sp.csr_matrix((z["adj_data"], z["adj_indices"],
                             z["adj_indptr"]), shape=z["adj_shape"])
        if "attr_data" in z:
            x = np.asarray(sp.csr_matrix(
                (z["attr_data"], z["attr_indices"], z["attr_indptr"]),
                shape=z["attr_shape"]).todense(), dtype=np.float32)
        else:
            x = np.asarray(z["attr_matrix"], dtype=np.float32)
        y = np.asarray(z["labels"], dtype=np.int64)
    coo = adj.tocoo()
    return NodeDataset(name=name, x=x, senders=coo.row.astype(np.int64),
                       receivers=coo.col.astype(np.int64), y=y)


# ---------------------------------------------------------------------------
# GraphSAINT format (Flickr / Reddit / Yelp)
# ---------------------------------------------------------------------------

def load_graphsaint(root: str, name: str) -> NodeDataset:
    """GraphSAINT layout: ``adj_full.npz`` (CSR), ``feats.npy``,
    ``class_map.json``, ``role.json`` (tr/va/te index lists)."""
    import scipy.sparse as sp
    raw = os.path.join(root, name, "raw")
    adj_p = os.path.join(raw, "adj_full.npz")
    if not os.path.exists(adj_p):
        raise _missing(name, raw, "GraphSAINT adj_full.npz/feats.npy/"
                                  "class_map.json/role.json")
    adj = sp.load_npz(adj_p).tocoo()
    x = np.load(os.path.join(raw, "feats.npy")).astype(np.float32)
    with open(os.path.join(raw, "class_map.json")) as f:
        cmap = json.load(f)
    n = x.shape[0]
    first = next(iter(cmap.values()))
    if isinstance(first, list):
        y = np.zeros((n, len(first)), dtype=np.int64)
        for k, v in cmap.items():
            y[int(k)] = v
    else:
        y = np.zeros(n, dtype=np.int64)
        for k, v in cmap.items():
            y[int(k)] = v
    masks = {}
    role_p = os.path.join(raw, "role.json")
    if os.path.exists(role_p):
        with open(role_p) as f:
            role = json.load(f)
        for part, attr in (("tr", "train_mask"), ("va", "val_mask"),
                           ("te", "test_mask")):
            m = np.zeros(n, dtype=bool)
            m[np.asarray(role[part], dtype=np.int64)] = True
            masks[attr] = m
    return NodeDataset(name=name, x=x, senders=adj.row.astype(np.int64),
                       receivers=adj.col.astype(np.int64), y=y, **masks)


# ---------------------------------------------------------------------------
# QM9 raw sdf format
# ---------------------------------------------------------------------------

QM9_ATOMS = {"H": 0, "C": 1, "N": 2, "O": 3, "F": 4}


def load_qm9_sdf(root: str, max_molecules: Optional[int] = None
                 ) -> GraphDataset:
    """Parse ``gdb9.sdf`` + ``gdb9.sdf.csv`` (the PyG QM9 raw pair):
    features = atom-type one-hot (5) + atomic coords (3) + bond-degree;
    targets = the 19 property columns of the csv."""
    raw = os.path.join(root, "QM9", "raw")
    sdf_p = os.path.join(raw, "gdb9.sdf")
    csv_p = os.path.join(raw, "gdb9.sdf.csv")
    if not (os.path.exists(sdf_p) and os.path.exists(csv_p)):
        raise _missing("QM9", raw, "gdb9.sdf + gdb9.sdf.csv")

    targets = []
    with open(csv_p) as f:
        next(f)
        for line in f:
            parts = line.strip().split(",")
            targets.append([float(v) for v in parts[1:20]])
    targets = np.asarray(targets, dtype=np.float32)

    graphs = []
    kept_rows = []   # csv row per KEPT molecule — skipped blocks must skip
    # their target row too, or every later graph pairs with the wrong labels
    with open(sdf_p) as f:
        content = f.read()
    for bi, block in enumerate(content.split("$$$$\n")):
        if max_molecules is not None and bi >= max_molecules:
            break
        lines = block.splitlines()
        if len(lines) < 4:
            continue
        counts = lines[3].split()
        try:
            na, nb = int(counts[0]), int(counts[1])
        except (ValueError, IndexError):
            continue
        feats = np.zeros((na, 9), dtype=np.float32)
        ok = True
        for i in range(na):
            p = lines[4 + i].split()
            try:
                feats[i, :3] = [float(p[0]), float(p[1]), float(p[2])]
                feats[i, 3 + QM9_ATOMS.get(p[3], 4)] = 1.0
            except (ValueError, IndexError):
                ok = False
                break
        if not ok:
            continue
        s_list, r_list = [], []
        for i in range(nb):
            p = lines[4 + na + i].split()
            try:
                a, b = int(p[0]) - 1, int(p[1]) - 1
            except (ValueError, IndexError):
                continue
            if 0 <= a < na and 0 <= b < na:
                s_list.append(a)
                r_list.append(b)
        s = np.asarray(s_list, dtype=np.int32)
        r = np.asarray(r_list, dtype=np.int32)
        deg = np.zeros(na, dtype=np.float32)
        np.add.at(deg, s, 1.0)
        np.add.at(deg, r, 1.0)
        feats[:, 8] = deg
        if bi >= len(targets):
            break
        graphs.append((feats, s, r))
        kept_rows.append(bi)
    return GraphDataset(name="QM9", graphs=graphs,
                        y=targets[np.asarray(kept_rows, dtype=np.int64)])


# ---------------------------------------------------------------------------
# OGB node-property raw format (ogbn-arxiv / ogbn-products / ogbn-proteins)
# ---------------------------------------------------------------------------

def _read_csv_gz(path: str, dtype) -> np.ndarray:
    """A headerless numeric ``.csv.gz`` as a (rows, columns) array of
    ``dtype``: decompressed whole and parsed by one ``np.fromstring`` (a
    per-line parse, or ``np.loadtxt`` in older numpy, takes hours on the
    products-scale files; the JAX package uses pandas, which the port
    leaves out).  Floats are parsed as float64, then cast, as pandas'
    frame is."""
    with gzip.open(path, "rb") as f:
        text = f.read().replace(b"\r\n", b"\n").strip()
    if not text:
        raise ValueError(f"{path}: no rows")
    cols = text[:text.find(b"\n") if b"\n" in text else len(text)
                ].count(b",") + 1
    rows = text.count(b"\n") + 1
    parse = np.int64 if np.issubdtype(dtype, np.integer) else np.float64
    with warnings.catch_warnings():
        # numpy warns, then stops, at a field it cannot parse: the count
        # check below turns that into an error
        warnings.simplefilter("ignore", DeprecationWarning)
        vals = np.fromstring(text.replace(b"\n", b",").decode("ascii"),
                             dtype=parse, sep=",")
    if vals.size != rows * cols:
        raise ValueError(f"{path}: expected {rows} rows of {cols} numbers, "
                         f"parsed {vals.size} values")
    return vals.reshape(rows, cols).astype(dtype)


def load_ogbn(root: str, name: str) -> NodeDataset:
    """Parse the extracted OGB layout: ``raw/node-feat.csv.gz``,
    ``raw/edge.csv.gz``, ``raw/node-label.csv.gz`` and the official split
    index files under ``split/*/{train,valid,test}.csv.gz``.

    ogbn-proteins ships no node features (the reference feeds the PyG
    dataset whose ``x`` is None, ``main.py:65-68``); node features are then
    synthesized from the mean of incident edge features
    (``raw/edge-feat.csv.gz``) or a species one-hot
    (``raw/node_species.csv.gz``)."""
    base = os.path.join(root, name)
    raw = os.path.join(base, "raw")
    feat_p = os.path.join(raw, "node-feat.csv.gz")
    edge_p = os.path.join(raw, "edge.csv.gz")
    label_p = os.path.join(raw, "node-label.csv.gz")
    if not os.path.exists(edge_p):
        raise _missing(name, raw, "OGB edge.csv.gz file")
    edges = _read_csv_gz(edge_p, np.int64)
    y = (_read_csv_gz(label_p, np.int64)
         if os.path.exists(label_p) else None)

    if os.path.exists(feat_p):
        x = _read_csv_gz(feat_p, np.float32)
    else:
        n_nodes = int(edges.max()) + 1 if y is None else max(
            int(edges.max()) + 1, len(y))
        efeat_p = os.path.join(raw, "edge-feat.csv.gz")
        species_p = os.path.join(raw, "node_species.csv.gz")
        if os.path.exists(efeat_p):
            ef = _read_csv_gz(efeat_p, np.float32)
            sums = np.zeros((n_nodes, ef.shape[1]), dtype=np.float64)
            deg = np.bincount(edges[:, 0], minlength=n_nodes) \
                + np.bincount(edges[:, 1], minlength=n_nodes)
            for d in range(ef.shape[1]):
                sums[:, d] = (
                    np.bincount(edges[:, 0], weights=ef[:, d],
                                minlength=n_nodes)
                    + np.bincount(edges[:, 1], weights=ef[:, d],
                                  minlength=n_nodes))
            x = (sums / np.maximum(deg, 1)[:, None]).astype(np.float32)
        elif os.path.exists(species_p):
            sp_ = _read_csv_gz(species_p, np.int64).reshape(-1)
            _, inv = np.unique(sp_, return_inverse=True)
            x = np.eye(int(inv.max()) + 1, dtype=np.float32)[inv]
        else:
            raise _missing(name, raw,
                           "node-feat, edge-feat, or node_species csv.gz")

    if y is None:
        y = np.zeros(x.shape[0], np.int64)
    if y.ndim > 1 and y.shape[1] == 1:
        y = y[:, 0]

    n = x.shape[0]
    masks = {}
    split_root = os.path.join(base, "split")
    if os.path.isdir(split_root):
        sub = sorted(os.listdir(split_root))
        if sub:
            sdir = os.path.join(split_root, sub[0])
            for part, attr in (("train", "train_mask"), ("valid", "val_mask"),
                               ("test", "test_mask")):
                p = os.path.join(sdir, f"{part}.csv.gz")
                if os.path.exists(p):
                    idx = _read_csv_gz(p, np.int64).reshape(-1)
                    m = np.zeros(n, dtype=bool)
                    m[idx] = True
                    masks[attr] = m
    return NodeDataset(name=name, x=x, senders=edges[:, 0],
                       receivers=edges[:, 1], y=y, **masks)


def load_node_dataset(name: str, root: str = "./dataset") -> NodeDataset:
    """Load a node-task dataset by reference name: the npz cache first,
    else the raw files of its format.

    ``random`` / ``random_<N>``: the reference's synthetic scalability ring
    (each node linked to its 1- and 2-hop ring neighbours, scalar integer
    features, one class), made on the fly as the JAX package makes it."""
    key = name.lower()
    if key == "random" or key.startswith("random_"):
        n = int(key.split("_", 1)[1]) if "_" in key else 1000
        rng = np.random.default_rng(0)
        i = np.arange(n, dtype=np.int64)
        senders = np.concatenate([i, (i + 1) % n, i, (i + 2) % n])
        receivers = np.concatenate([(i + 1) % n, i, (i + 2) % n, i])
        return NodeDataset(
            name=key, x=rng.integers(0, 10, (n, 1)).astype(np.float32),
            senders=senders, receivers=receivers,
            y=np.zeros(n, dtype=np.int64))
    cache = os.path.join(root, key, f"{key}.npz")
    if os.path.exists(cache):
        return load_npz_cache(cache, key)
    if key in ("cora", "citeseer", "pubmed"):
        return load_planetoid(root, key)
    if key in NODE_REG:
        return load_wikipedia_network(root, key)
    if key.startswith("ogbn-"):
        return load_ogbn(root, key)
    if key == "wikics":
        return load_wikics(root)
    if key == "flickr":
        try:
            return load_graphsaint(root, key)
        except DatasetNotFoundError:
            return load_attributed_npz(root, key)
    if key in ("physics", "dblp"):
        return load_attributed_npz(root, key)
    raise _missing(name, root, f"{key}.npz standardized cache")


def save_graph_cache(path: str, ds: GraphDataset) -> None:
    """Write ``ds`` as a ``<name>_graphs.npz`` cache: ``graphs`` an object
    array of ``(x, senders, receivers)`` tuples, ``y`` the targets."""
    graphs = np.empty(len(ds.graphs), dtype=object)
    for i, g in enumerate(ds.graphs):
        graphs[i] = tuple(g)
    np.savez_compressed(path, graphs=graphs, y=np.asarray(ds.y))


def load_zinc_pickle(root: str, name: str = "ZINC",
                     subset: bool = True) -> GraphDataset:
    """ZINC molecules in the benchmarking-gnns pickle layout
    (``{train,val,test}.pickle`` of dicts with torch tensors: atom_type,
    bond_type/edge_list, logP_SA_cycle_normalized; ``numpy.asarray``
    reads the tensors); 4,000 molecules a part when ``subset``."""
    raw = os.path.join(root, name, "raw")
    parts = ["train", "val", "test"]
    paths = [os.path.join(raw, f"{p}.pickle") for p in parts]
    if not all(os.path.exists(p) for p in paths):
        raise _missing(name, raw, "benchmarking-gnns {train,val,test}.pickle")

    graphs, ys = [], []
    for p in paths:
        with open(p, "rb") as f:
            mols = pickle.load(f)
        if subset and len(mols) > 4000:
            mols = mols[:4000]
        for mol in mols:
            atom = np.asarray(mol["atom_type"], dtype=np.int64).reshape(-1)
            n = len(atom)
            x = np.eye(28, dtype=np.float32)[np.clip(atom, 0, 27)]
            bond = np.asarray(mol["bond_type"])
            if bond.ndim == 2 and bond.shape == (n, n):
                s, r = np.nonzero(bond)
            else:
                e = np.asarray(mol.get("edge_list", bond),
                               dtype=np.int64).reshape(-1, 2)
                s, r = e[:, 0], e[:, 1]
            graphs.append((x, s.astype(np.int32), r.astype(np.int32)))
            ys.append(float(np.asarray(
                mol["logP_SA_cycle_normalized"]).reshape(-1)[0]))
    return GraphDataset(name=name, graphs=graphs,
                        y=np.asarray(ys, dtype=np.float32))


def load_graph_dataset(name: str, root: str = "./dataset") -> GraphDataset:
    """Load a graph-level dataset from its ``<name>_graphs.npz`` cache (the
    JAX package's format; the cache holds pickled objects, so load only
    caches this program or the JAX package wrote), else from the raw
    files of its format (TU, ZINC's pickles, QM9's sdf)."""
    cache = os.path.join(root, name, f"{name}_graphs.npz")
    if os.path.exists(cache):
        with np.load(cache, allow_pickle=True) as z:
            return GraphDataset(name=name, graphs=list(z["graphs"]),
                                y=z["y"])
    if name in GRAPH_CLS:
        return load_tu_dataset(root, name)
    if name.startswith("ZINC"):
        return load_zinc_pickle(root, "ZINC", subset="subset" in name)
    if name == "QM9":
        return load_qm9_sdf(root)
    raise _missing(name, root, f"{name}_graphs.npz cache or TU raw files")
