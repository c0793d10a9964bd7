#!/usr/bin/env python3
"""The tile walks' kernel times of ``chip_smoke.py`` alone, as one JSON line,
on one GPU: a cheap way to compare two checkouts on one card.

    python3 scripts/torch_kernel_rows.py [CHECKOUT] [--edge256] [--gat]
        [--fused]

CHECKOUT (default: this repository) is the root of the checkout whose
``chip_smoke.py`` and ``fitgnn_tpu_torch/`` run; its kernels build into its
own ``build/``.  The script builds every kernel, makes the bench graph
(seed 0), then runs ``chip_smoke.py``'s phase 3 (K1 and K3 on the default
operator at F=128 and 512) and phase 5's kernel rows (K2, K9, K10 and K8's
four forms on the opt-in operators), each checked against its plain
version, and prints ``ROWS {"checkout": ..., "rows": {"K1 F=512": ms,
...}}``, then ``DETAIL`` with each row's bound and library time and,
where the checkout has them, the bound over every quadrant of a live
tile beside a walk's bound over the live quadrants (``bound_tiles_ms``)
and the walk without occupancy words (``nowords_ms``), the time with the
wrapper's host work (``wrapper_ms``) and K7s's both outputs
(``both_outputs_ms``); with ``--edge256`` also phase 14's rows at tile edge
256 (K1, K2, K9, K8 and their bf16 forms; a checkout from before that
phase has none).
With ``--gat`` also phase 3's GAT rows (K4, K4ᵀ and K5 on the
``att_unit`` operator at F=128 and 512), and with both flags phase 15's
(K4, K4ᵀ and K5 at tile edge 256, where the checkout has that phase).
``--fused`` (with ``--gat``) adds phase 3's fused rows (K7rm, K7f, K7bt,
K7s, K7sums, K6 and K3w), and with ``--edge256`` phase 16's (the K7 forms
at 256, f32 and bf16, where the checkout has that phase).
Parent against change, alternated in one call:

    for d in build/parent . . build/parent; do
        python3 scripts/torch_kernel_rows.py $d; done
"""

from __future__ import annotations

import json
import os
import sys


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = os.path.abspath(args[0] if args else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from fitgnn_tpu_torch.data.datasets import NodeDataset
    from fitgnn_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    cs.phase_build()
    x, s, r, y, train = cs.make_graph()
    ds = NodeDataset("bench", x, s, r, y, train_mask=train)
    g, order, shapes = cs.phase_kernels(device, ds)
    shapes.update(cs.phase_optin_kernels(device, g,
                                         cs.optin_operators(ds, g)))
    ids = ["K1", "K3", "K2", "K9", "K10", "K8"]
    if "--edge256" in sys.argv:
        shapes.update(cs.phase_block_kernels(device, cs.block_operators(g)))
        ids += [f"{k}@{cs.EDGE}" for k in cs.EDGE_IDS]
    fused = "--fused" in sys.argv
    if "--gat" in sys.argv:
        g_gat, gat_shapes = cs.phase_gat_kernels(device, ds, g)
        shapes.update(gat_shapes)
        ids += ["K4", "K4T", "K5"]
        if fused:
            for k, v in cs.phase_fused_kernels(device, g_gat).items():
                shapes.setdefault(k, []).extend(v)
            ids += ["K7rm", "K7f", "K7bt", "K7s", "K7sums", "K6", "K3w"]
        del g_gat
        if "--edge256" in sys.argv and hasattr(cs, "gat_block_operators"):
            ops = cs.gat_block_operators(g, ds, order)
            shapes.update(cs.phase_gat_block_kernels(device,
                                                     ops["t48"].aux))
            if fused and hasattr(cs, "phase_gat_fused_block_kernels"):
                shapes.update(cs.phase_gat_fused_block_kernels(device, ops))
            ids += [f"{k}@{cs.EDGE}" for k in cs.GAT_EDGE_IDS]
    rows = {f"{k} {sh.get('shape') or 'F=%s' % sh['F']}"
            f"{' ' + sh['launch'] if 'launch' in sh else ''}": sh
            for k in ids if k in shapes for sh in shapes[k]}
    print("ROWS " + json.dumps({"checkout": root, "rows": {
        k: sh["ms"] for k, sh in rows.items()}}))
    keys = ("bound_ms", "bound_tiles_ms", "library_ms", "nowords_ms",
            "wrapper_ms", "both_outputs_ms")
    print("DETAIL " + json.dumps({"checkout": root, "rows": {
        k: {f: sh[f] for f in keys if f in sh} for k, sh in rows.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
