"""Scaling of the port's flat data-mesh training step: edges/s on 1..P
ranks, the port of ``scripts/scaling_bench.py``.

The same graph as the JAX script (``sbm_graph``'s features and labels,
edges drawn directly: 85% inside 256-node blocks), Leiden communities,
``placement_by_community``, ``shard_graph`` and ``build_halo_plan``;
then, for each device count P, P ranks (started as the CLI's
``--num_devices`` starts them: NCCL, card r for rank r, under ``--device
cuda``; gloo on the CPU under ``--device cpu``) time the GCN
``DistNodeModel``'s all-gather step and the ``DistNodeModelHalo``'s halo
step (dropout 0.5, the same seeded parameters).  One line a P: step ms,
edges/s, the efficiency against the first P, the MB a device receives a
layer, and the boundary rows (the plan's ``send_mask.sum()``).  A P
larger than the visible cards is skipped; NCCL puts no two ranks on one
card.  On the CPU the ranks share the host's cores, so the times there
check the logic and the balance, not a device.

Usage: python scripts/torch_scaling_bench.py [--nodes N]
       [--devices 1 2 4 8] [--steps 5] [--device cuda|cpu]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _rank(rank, p, store, out, sg, plan, args):
    """One rank: both steps, a warm-up then ``args.steps`` timed; rank 0
    writes {table: [seconds a step, last loss]} to ``out``."""
    import torch
    import torch.distributed as dist
    from fitgnn_tpu_torch.parallel import (DistNodeModel, DistNodeModelHalo,
                                           create_dist_state,
                                           initialize_distributed,
                                           make_dist_train_step,
                                           make_halo_train_step, make_mesh)
    from fitgnn_tpu_torch.train.steps import adam_l2
    from fitgnn_tpu_torch.utils.device import resolve_device

    if args.device == "cuda":
        device = resolve_device(f"cuda:{rank}")
    else:
        device = resolve_device("cpu")
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // p))
    initialize_distributed(device, f"file://{store}", rank, p)
    try:
        mesh = make_mesh(p)
        shard = sg.local(rank, device)
        edges = sg.local_edges(rank, device)
        local_plan = plan.local(rank, device)
        f = sg.x.shape[-1]
        model, opt = create_dist_state(
            DistNodeModel("GCNConv", f, args.hidden, 2, 8), 0, device)
        halo_model = DistNodeModelHalo("GCNConv", f, args.hidden, 2, 8)
        halo_model.load_state_dict(model.state_dict())
        halo_model.to(device)
        halo_opt = adam_l2(halo_model.parameters(), 0.01, 5e-4)
        step = make_dist_train_step(mesh, model)
        halo_step = make_halo_train_step(mesh, halo_model, local_plan)
        runs = {
            "all-gather": lambda gen: step(opt, shard, edges, gen),
            "halo": lambda gen: halo_step(halo_opt, shard, gen)}
        rows = {}
        for name, run in runs.items():
            gen = torch.Generator(device).manual_seed(1)
            run(gen)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                loss = run(gen)
            loss = float(loss)
            dt = (time.perf_counter() - t0) / args.steps
            rows[name] = [dt, loss]
        if rank == 0:
            with open(out, "w") as fh:
                json.dump(rows, fh)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=65536)
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch
    import torch.multiprocessing as mp
    from fitgnn_tpu_torch.data.splits import splits_classification
    from fitgnn_tpu_torch.data.synthetic import sbm_graph
    from fitgnn_tpu_torch.parallel import (build_halo_plan,
                                           placement_by_community,
                                           shard_graph)
    from fitgnn_tpu_torch.partition.community import leiden_communities

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda but torch.cuda.is_available() "
                             "is False (--device cpu runs gloo ranks)")
        available = torch.cuda.device_count()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    else:
        available = None

    n = args.nodes
    x, _, _, y = sbm_graph(num_nodes=n, num_classes=8,
                           num_features=args.features, p_in=0.0, p_out=0.0,
                           seed=0)
    # build edges directly (sbm_graph's sampler is slow at this scale)
    rng = np.random.default_rng(0)
    e = n * args.degree // 2
    rcv = rng.integers(0, n, e)
    comm = rcv // 256
    snd = np.where(rng.random(e) < 0.85,
                   comm * 256 + rng.integers(0, 256, e),
                   rng.integers(0, n, e))
    keep = snd != rcv
    snd, rcv = snd[keep], rcv[keep]
    train, _, _ = splits_classification(y, 8, "ogbn_split", seed=0)
    labels = leiden_communities(snd, rcv, n, seed=0)

    print(f"per-layer collective traffic per device (the scaling-relevant "
          f"quantity; {args.device}: "
          + ("NCCL, one card a rank)" if args.device == "cuda" else
             "gloo ranks sharing the host's cores)") + ":")
    base = {}
    for p in args.devices:
        if available is not None and p > available:
            print(f"skip P={p}: only {available} devices", file=sys.stderr)
            continue
        order, _ = placement_by_community(labels, p)
        sg = shard_graph(x, snd, rcv, y, p, train_mask=train, order=order)
        plan = build_halo_plan(sg.senders, sg.receivers, sg.edge_weight, p,
                               sg.nodes_per_shard)
        gather_mb = sg.num_nodes_global * args.hidden * 4 / 1e6
        halo_mb = p * plan.k * args.hidden * 4 / 1e6
        cut = int(plan.send_mask.sum())
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "rows.json")
            mp.spawn(_rank, args=(p, os.path.join(tmp, "store"), out, sg,
                                  plan, args), nprocs=p, join=True)
            with open(out) as fh:
                rows = json.load(fh)
        res = {}
        for name, (dt, _) in rows.items():
            eps = len(snd) * 2 / dt
            base.setdefault(name, eps)
            res[name] = (dt, eps, eps / (base[name] * p))
        ag, ha = res["all-gather"], res["halo"]
        print(f"P={p}: all-gather {ag[0]*1e3:7.1f} ms  {ag[1]/1e6:7.2f} Me/s "
              f"(eff {ag[2]:.2f}, recv {gather_mb:7.2f} MB/dev/layer) | "
              f"halo {ha[0]*1e3:7.1f} ms  {ha[1]/1e6:7.2f} Me/s "
              f"(eff {ha[2]:.2f}, recv {halo_mb:7.2f} MB/dev/layer, "
              f"{cut} boundary rows)", flush=True)


if __name__ == "__main__":
    main()
