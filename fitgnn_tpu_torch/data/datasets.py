"""Datasets: the standardized npz caches.

A node-task dataset lives at ``<root>/<name>/<name>.npz`` with arrays
``x``, ``senders``, ``receivers``, ``y`` and optional ``train_mask``,
``val_mask``, ``test_mask`` — the JAX package's cache format, written by
``save_npz_cache``.  ``random`` / ``random_<N>`` is the synthetic ring,
made on the fly.  A graph-level dataset lives at
``<root>/<name>/<name>_graphs.npz``: an object array ``graphs`` of
``(x, senders, receivers)`` and the targets ``y`` (``save_graph_cache``).
The loaders of raw formats (Planetoid, OGB, TU, ZINC, QM9, WikiCS,
GraphSAINT, ...) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

NODE_CLS = ("cora", "citeseer", "pubmed", "dblp", "physics", "wikics",
            "ogbn-arxiv", "ogbn-products", "ogbn-proteins", "flickr")
NODE_REG = ("chameleon", "squirrel", "crocodile")
GRAPH_CLS = ("ENZYMES", "PROTEINS", "AIDS")
GRAPH_REG = ("QM9", "ZINC", "ZINC_subset")


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
        f"Place an npz cache there (see save_npz_cache/load_npz_cache).")


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


def load_node_dataset(name: str, root: str = "./dataset") -> NodeDataset:
    """Load a node-task dataset from its npz cache.

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
    if key in NODE_CLS or key in NODE_REG:
        raise NotImplementedError(
            f"no npz cache at {cache!r}, and the raw-format loader for "
            f"{key!r} is not ported yet (ROADMAP.md §1); convert it with "
            "the JAX package's loader and save_npz_cache")
    raise _missing(name, root, f"{key}.npz standardized cache")


def save_graph_cache(path: str, ds: GraphDataset) -> None:
    """Write ``ds`` as a ``<name>_graphs.npz`` cache: ``graphs`` an object
    array of ``(x, senders, receivers)`` tuples, ``y`` the targets."""
    graphs = np.empty(len(ds.graphs), dtype=object)
    for i, g in enumerate(ds.graphs):
        graphs[i] = tuple(g)
    np.savez_compressed(path, graphs=graphs, y=np.asarray(ds.y))


def load_graph_dataset(name: str, root: str = "./dataset") -> GraphDataset:
    """Load a graph-level dataset from its ``<name>_graphs.npz`` cache (the
    JAX package's format; the cache holds pickled objects, so load only
    caches this program or the JAX package wrote)."""
    cache = os.path.join(root, name, f"{name}_graphs.npz")
    if os.path.exists(cache):
        with np.load(cache, allow_pickle=True) as z:
            return GraphDataset(name=name, graphs=list(z["graphs"]),
                                y=z["y"])
    if name in GRAPH_CLS or name.startswith("ZINC") or name == "QM9":
        raise NotImplementedError(
            f"no graph cache at {cache!r}, and the raw-format loader for "
            f"{name!r} is not ported yet (ROADMAP.md §1, other dataset "
            "loaders); convert it with the JAX package's loader into a "
            "<name>_graphs.npz cache")
    raise _missing(name, root, f"{name}_graphs.npz graph cache")
