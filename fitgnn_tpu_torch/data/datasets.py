"""Node-task datasets: the standardized npz cache.

A dataset lives at ``<root>/<name>/<name>.npz`` with arrays ``x``,
``senders``, ``receivers``, ``y`` and optional ``train_mask``,
``val_mask``, ``test_mask`` — the JAX package's cache format, written by
``save_npz_cache``.  The loaders of raw formats (Planetoid, OGB, TU,
WikiCS, GraphSAINT, ...) and the synthetic ``random_<N>`` ring are not
ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

NODE_CLS = ("cora", "citeseer", "pubmed", "dblp", "physics", "wikics",
            "ogbn-arxiv", "ogbn-products", "ogbn-proteins", "flickr")
NODE_REG = ("chameleon", "squirrel", "crocodile")


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
    """Load a node-task dataset from its npz cache."""
    key = name.lower()
    cache = os.path.join(root, key, f"{key}.npz")
    if os.path.exists(cache):
        return load_npz_cache(cache, key)
    if key in NODE_CLS or key in NODE_REG or key.startswith("random"):
        raise NotImplementedError(
            f"no npz cache at {cache!r}, and the raw-format loader for "
            f"{key!r} is not ported yet (ROADMAP.md §1); convert it with "
            "the JAX package's loader and save_npz_cache")
    raise _missing(name, root, f"{key}.npz standardized cache")
