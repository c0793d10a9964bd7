"""Training observability: per-run scalar logging.

The reference writes TensorBoard scalars per run.  The port writes, as the
JAX package's primary sink does, an append-only JSONL stream per run:
``{"tag", "value", "step", "t"}`` rows in ``<logdir>/run_<k>/scalars.jsonl``.
The JAX package's optional TensorBoard sink and its resume trimming
(``trim_replay``) are not ported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class ScalarWriter:
    """Append scalars as JSONL rows: {"tag", "value", "step", "t"}."""

    def __init__(self, logdir: str, run: Optional[int] = None):
        self.dir = logdir if run is None else os.path.join(logdir,
                                                           f"run_{run}")
        os.makedirs(self.dir, exist_ok=True)
        self._f = open(os.path.join(self.dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step),
                                  "t": time.time()}) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
