"""Build native shared libraries from the repository's sources at first use.

Every library lands in ``build/fitgnn_tpu_torch/`` at the repository root
(listed in ``.gitignore``).  A library is rebuilt when any of its sources is
newer than it.  Builds are safe for several processes at once (pytest-xdist
workers, say): one file lock serialises them, each compiler writes a private
temporary file, and ``os.replace`` moves it into place atomically, so no
process ever loads a half-written library.  All stale targets of one call
compile in parallel, one compiler process per source.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import subprocess
from typing import Callable, Sequence

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "fitgnn_tpu_torch")


class Target:
    """One shared library: ``cmd(tmp_out)`` is the compiler command line
    that writes the library to ``tmp_out``."""

    def __init__(self, name: str, sources: Sequence[str],
                 cmd: Callable[[str], list]):
        self.name = name
        self.sources = list(sources)
        self.cmd = cmd

    @property
    def path(self) -> str:
        return os.path.join(BUILD_DIR, f"lib{self.name}.so")

    @property
    def log_path(self) -> str:
        return os.path.join(BUILD_DIR, f"lib{self.name}.log")

    def stale(self) -> bool:
        if not os.path.exists(self.path):
            return True
        built = os.path.getmtime(self.path)
        return any(os.path.getmtime(s) > built for s in self.sources)


@contextlib.contextmanager
def _build_lock():
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as fd:
        fcntl.flock(fd, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)


def build(targets: Sequence[Target]) -> list:
    """Compile every stale target, all in parallel; returns the names built.

    The compiler's output goes to ``lib<name>.log`` beside the library; a
    failed build raises with that log."""
    with _build_lock():
        todo = [t for t in targets if t.stale()]
        running = []
        for t in todo:
            tmp = f"{t.path}.{os.getpid()}.tmp"
            log = open(t.log_path, "w")
            proc = subprocess.Popen(t.cmd(tmp), stdout=log,
                                    stderr=subprocess.STDOUT)
            running.append((t, tmp, proc, log))
        failed = []
        for t, tmp, proc, log in running:
            proc.wait()
            log.close()
            if proc.returncode == 0:
                os.replace(tmp, t.path)
            else:
                with contextlib.suppress(FileNotFoundError):
                    os.remove(tmp)
                with open(t.log_path) as f:
                    failed.append(f"{t.name} (exit {proc.returncode}):\n"
                                  f"{f.read()}")
        if failed:
            raise RuntimeError("native build failed: " + "\n".join(failed))
        return [t.name for t in todo]
