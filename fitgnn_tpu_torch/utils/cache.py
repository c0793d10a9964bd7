"""Content-hashed cache of preprocessing artifacts (the partition).

The key is a hash of the inputs and the configuration, as the JAX
package's ``utils/cache.py`` computes it, so an entry can never be
silently wrong.  The port keeps its artifacts apart from the JAX
package's: callers add a ``"artifact": ARTIFACT_KIND`` entry to the key's
configuration and root the cache in a directory of its own.  An artifact
holds only numpy arrays, plain values and the port's own types (tensors
are stored as numpy arrays), and loading refuses any pickle that names a
module of the JAX package or of JAX, so the port never unpickles the JAX
package's artifacts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from typing import Any, Mapping, Optional

import numpy as np
import torch

# the key entry and directory name that set the port's artifacts apart
ARTIFACT_KIND = "fitgnn_tpu_torch"


def content_key(arrays: Mapping[str, np.ndarray],
                config: Mapping[str, Any]) -> str:
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes()[: 1 << 22])   # cap hashing cost on huge arrays
    for k in sorted(config):
        h.update(f"{k}={config[k]};".encode())
    return h.hexdigest()[:20]


class StoredTensor:
    """A tensor in an artifact: its numpy value, back to a CPU tensor on
    load."""

    def __init__(self, array: np.ndarray):
        self.array = array


def _pack(obj: Any) -> Any:
    """Every tensor of ``obj`` (tuples, named tuples, lists, dicts and
    dataclasses, recursively) as a ``StoredTensor`` of its CPU value."""
    if isinstance(obj, torch.Tensor):
        return StoredTensor(obj.detach().cpu().numpy())
    return _map(obj, _pack)


def _unpack(obj: Any) -> Any:
    if isinstance(obj, StoredTensor):
        return torch.from_numpy(obj.array)
    return _map(obj, _unpack)


def _map(obj: Any, fn) -> Any:
    if isinstance(obj, tuple):
        vals = [fn(v) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") \
            else type(obj)(vals)
    if isinstance(obj, list):
        return [fn(v) for v in obj]
    if isinstance(obj, dict):
        return {k: fn(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: fn(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


class _PortUnpickler(pickle.Unpickler):
    """Refuses any class of JAX or of the JAX package (``fitgnn_tpu``)."""

    def find_class(self, module: str, name: str):
        top = module.split(".", 1)[0]
        if top in ("jax", "jaxlib", "fitgnn_tpu", "flax", "optax"):
            raise pickle.UnpicklingError(
                f"artifact names {module}.{name}: not an artifact of "
                "fitgnn_tpu_torch")
        return super().find_class(module, name)


class ArtifactCache:
    def __init__(self, root: str = "./artifacts_cache"):
        self.root = root

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.pkl")

    def load(self, key: str) -> Optional[Any]:
        p = self._path(key)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return _unpack(_PortUnpickler(f).load())

    def save(self, key: str, obj: Any) -> None:
        os.makedirs(self.root, exist_ok=True)
        tmp = f"{self._path(key)}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(_pack(obj), f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self._path(key))

    def load_or_compute(self, key: str, fn):
        hit = self.load(key)
        if hit is not None:
            return hit, True
        obj = fn()
        self.save(key, obj)
        return obj, False
