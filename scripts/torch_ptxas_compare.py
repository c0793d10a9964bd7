#!/usr/bin/env python3
"""Compare the ``ptxas -v`` register and spill lines of the port's CUDA
kernels between two checkouts, entry by entry.

    python3 scripts/torch_ptxas_compare.py PARENT [CHANGE]

Builds every kernel library of each checkout (``CHANGE`` defaults to this
one) with its own ``nvcc`` build, in parallel, into the checkout's own
``build/fitgnn_tpu_torch/``, reads each library's ``lib<name>.log`` and
pairs the entry functions by their demangled names.  A template parameter
that the change appends with a default (the activations' type of the
walk and of the straggler sum) is read off the change's names where it is
``float``, so an instantiation the parent had pairs with its own; one
whose appended parameters are not ``float`` is a new form, listed apart.
Prints one JSON object (``same``, ``differ``, ``missing`` from the
change, ``new`` in it) and exits 1 if any pair differs or is missing.
Needs ``nvcc``: run it on the chip machine.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = ("from fitgnn_tpu_torch.ops import kernels; "
         "from fitgnn_tpu_torch.utils.build import build; "
         "build(kernels.TARGETS)")


def _split_args(name: str) -> tuple:
    """(base, [template arguments]) of a demangled name, split at the top
    level; (name, None) without a template list."""
    if "<" not in name:
        return name, None
    base, rest = name.split("<", 1)
    args, depth, cur = [], 0, ""
    for ch in rest[:-1]:
        if ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
            continue
        depth += {"<": 1, ">": -1}.get(ch, 0)
        cur += ch
    args.append(cur.strip())
    return base, args


def entries(checkout: str) -> dict:
    """{(library, kernel): (registers, spilled bytes)} of a built
    checkout."""
    sys.path.insert(0, HERE)
    from chip_smoke import ptxas_entries
    from fitgnn_tpu_torch.ops.kernels import TARGETS
    out = {}
    for t in TARGETS:
        log = os.path.join(checkout, "build", "fitgnn_tpu_torch",
                           f"lib{t.name}.log")
        for kernel, regs, spill in ptxas_entries(log):
            out[(t.name, kernel)] = (regs, spill)
    return out


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(sys.argv[1])
    change = os.path.abspath(sys.argv[2]) if len(sys.argv) == 3 else HERE
    procs = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=d)
             for d in (parent, change)]
    if any(p.wait() for p in procs):
        print("a build failed", file=sys.stderr)
        return 1
    old, new = entries(parent), entries(change)
    arity = {}
    for lib, kernel in old:
        base, args = _split_args(kernel)
        arity[(lib, base)] = None if args is None else len(args)
    paired, fresh = {}, []
    for (lib, kernel), v in new.items():
        base, args = _split_args(kernel)
        n = arity.get((lib, base))
        if args is not None and n is not None and len(args) > n:
            if any(a != "float" for a in args[n:]):
                fresh.append([lib, kernel, *v])
                continue
            kernel = f"{base}<{', '.join(args[:n])}>"
        paired[(lib, kernel)] = v
    same = [k for k in old if paired.get(k) == old[k]]
    differ = [[*k, old[k], paired[k]] for k in old
              if k in paired and paired[k] != old[k]]
    missing = [list(k) for k in old if k not in paired]
    print(json.dumps({"same": len(same), "differ": differ,
                      "missing": missing, "new": fresh}, indent=1))
    return 1 if differ or missing else 0


if __name__ == "__main__":
    sys.exit(main())
