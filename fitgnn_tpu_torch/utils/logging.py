"""Training observability: per-run scalar logging.

The reference writes TensorBoard scalars per run.  The port writes, as the
JAX package's primary sink does, an append-only JSONL stream per run:
``{"tag", "value", "step", "t"}`` rows in ``<logdir>/run_<k>/scalars.jsonl``.
A resumed session drops the rows of the epochs it replays
(``trim_replay``).  The JAX package's optional TensorBoard sink is not
ported.
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

    def trim_replay(self, phase_prefix: str, min_step: int,
                    gc_done: bool = False) -> None:
        """Drop the rows a dead session logged for the epochs a resumed
        session replays, so (tag, step) stays unique: ``phase_prefix`` rows
        with ``step >= min_step``, and every ``Gs_`` row when the resume
        point is still in the Gc phase (``gc_done`` False)."""
        path = os.path.join(self.dir, "scalars.jsonl")
        self._f.close()
        kept = []
        with open(path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                tag = row.get("tag", "")
                replayed = (tag.startswith(phase_prefix)
                            and row.get("step", 0) >= min_step)
                if not gc_done and phase_prefix == "Gc_":
                    replayed = replayed or tag.startswith("Gs_")
                if not replayed:
                    kept.append(line)
        with open(path, "w") as f:
            f.writelines(kept)
        self._f = open(path, "a")

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
