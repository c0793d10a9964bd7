"""One rank of the gloo world that the distributed port tests start.

    python tests/torch_port_dist_worker.py RANK WORLD STORE SPEC OUT

``SPEC`` is a pickled list of cases (numpy inputs, made by the test);
every rank runs every case in order, on one (H × D) mesh a case, and
writes its results to ``OUT/<case>.<rank>.pkl``.  It imports torch, numpy
and the port alone, never JAX.  The cases:

* ``aggregate``: ``hier_aggregate`` of the shard's rows and the gradient
  of Σ tanh(out) over every rank;
* ``attention``: the same through ``hier_attention_aggregate``, under the
  case's GAT switches;
* ``train``: ``hier_train_step`` steps from the case's parameters (a
  ``NodeModel`` state dict), then ``hier_eval_step``: the losses, the
  first step's gradients (summed over the ranks), the parameters after
  the steps and the eval's (loss, metric);
* ``gs``: the subgraph-axis Gs steps on this rank's slice of the case's
  batches (``shard_batches``) from its parameters at dropout 0: the
  val and test evals (``dist_gs_eval_step``), then one GD step or one MB
  epoch; the evals, the loss, the parameters after it and Adam's step;
* ``gc_eval``: the distributed Gc phase of ``run_node_task``
  (``_make_hier_gc_steps`` on the case's coarse graph and config) from
  its parameters at dropout 0: the val eval's (loss, metric);
* ``run``: ``run_node_task`` of the case's config on its coarse graph and
  batches: the test (loss, metric), the epochs timed and the final
  parameters; with ``cut`` a first session stopped before that Gs val
  eval (its last resume save standing) is taken up by a second;
* ``flat_layers``: on the flat data mesh, the case's layer
  (``make_dist_conv``, from its parameters) on the all-gather and the halo
  table: the output, the gradient of Σ tanh(out) over every rank in the
  shard's rows and in the parameters (summed over the ranks); the halo
  table ``halo_exchange`` gives of rows that name their shard; and
  ``create_dist_state``'s parameters from the case's seed;
* ``flat_train``: ``make_dist_train_step`` (or ``make_halo_train_step``
  on the halo table) steps from the case's parameters, then
  ``make_dist_eval_step`` on the val rows: the losses, the parameters
  after the steps and the eval's (loss, metric).
"""

import os
import pickle
import subprocess
import sys
import time
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fitgnn_tpu_torch.models.models import NodeModel  # noqa: E402
from fitgnn_tpu_torch.parallel import (DistNodeModel,  # noqa: E402
                                       DistNodeModelHalo, HierNodeModel,
                                       build_hier_plan, create_dist_state,
                                       dist_gs_eval_step,
                                       dist_gs_train_epoch_mb,
                                       dist_gs_train_step_gd,
                                       hier_aggregate,
                                       hier_attention_aggregate,
                                       halo_exchange, hier_eval_step,
                                       hier_train_step, hier_view,
                                       initialize_distributed,
                                       make_dist_conv, make_dist_eval_step,
                                       make_dist_train_step,
                                       make_halo_train_step, make_hier_mesh,
                                       make_mesh, shard_batches)
from fitgnn_tpu_torch.parallel.collectives import \
    all_reduce_grads  # noqa: E402
from fitgnn_tpu_torch.parallel import dist_subgraphs  # noqa: E402
from fitgnn_tpu_torch.train import loop  # noqa: E402
from fitgnn_tpu_torch.train.checkpoint import optimizer_step  # noqa: E402
from fitgnn_tpu_torch.train.steps import adam_l2  # noqa: E402


def _plan(case, mesh):
    sg = case["sg"]
    plan = build_hier_plan(sg.senders, sg.receivers, case.get(
        "weights", sg.edge_weight), case["H"], case["D"], sg.nodes_per_shard,
        case["cluster_of"], **case.get("plan", {}))
    return sg, plan.local(mesh, "cpu")


class Cut(Exception):
    """A session stopped on purpose (the ``run`` case's ``cut``)."""


def _node_model(case):
    model = NodeModel(case["layer"], in_dim=case["in_dim"],
                      hidden=case["hidden"], num_layers=2,
                      out_dim=case["out_dim"],
                      classify=case["task"] == "classification",
                      dropout_rate=0.0)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["params"].items()})
    return model


def _state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def run_curriculum_case(case, rank, world):
    """The distributed curriculum's cases (``gs``, ``gc_eval``, ``run``)."""
    task = case.get("task")
    if case["kind"] == "gs":
        local = shard_batches(case["batches"], rank, world, "cpu")
        model = _node_model(case)
        evals = {split: tuple(float(v) for v in dist_gs_eval_step(
            model, local, task, split)) for split in ("val", "test")}
        opt = adam_l2(model.parameters(), case["lr"], case["wd"])
        if case["method"] == "GD":
            loss = dist_gs_train_step_gd(model, opt, local, None, task)
        else:
            loss = dist_gs_train_epoch_mb(model, opt, local, None, task,
                                          case["batch_size"], world)
        return {"evals": evals, "loss": float(loss),
                "params": _state(model), "steps": optimizer_step(opt)}
    if case["kind"] == "gc_eval":
        cfg = loop.NodeTaskConfig(**case["cfg"], device="cpu")
        steps = loop._make_hier_gc_steps(cfg, case["coarse"], "cpu")
        loss, metric = steps.evaluate(hier_view(_node_model(case)))
        return {"eval": (float(loss), float(metric))}
    # "run": the final model of each session is the last NodeModel built
    models = []

    class Recorded(NodeModel):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            models.append(self)

    cfg = loop.NodeTaskConfig(**case["cfg"], device="cpu")
    with mock.patch.object(loop, "NodeModel", Recorded):
        if case.get("cut") is not None:
            calls = [0]
            evaluate = dist_subgraphs.dist_gs_eval_step

            def cut_at(model, batches, task, split="val", group=None):
                calls[0] += 1
                if calls[0] == case["cut"]:
                    raise Cut
                return evaluate(model, batches, task, split, group)

            with mock.patch.object(dist_subgraphs, "dist_gs_eval_step",
                                   cut_at):
                try:
                    loop.run_node_task(cfg, case["coarse"], case["batches"])
                    raise AssertionError("the session was not cut")
                except Cut:
                    pass
        res = loop.run_node_task(cfg, case["coarse"], case["batches"])
    r = res.runs[-1]
    return {"test": (r.test_loss, r.test_acc),
            "epochs": (len(r.gc_epoch_seconds), len(r.gs_epoch_seconds)),
            "params": _state(models[-1])}


def run_flat_case(case, mesh):
    """The flat data mesh's cases (``flat_layers``, ``flat_train``)."""
    rank, sg, plan = mesh.rank, case["sg"], case["plan"]
    shard = sg.local(rank, "cpu")
    tables = {"gather": sg.local_edges(rank, "cpu"),
              "halo": plan.local(rank, "cpu")}
    if case["kind"] == "flat_train":
        edges = tables[case["table"]]
        cls = DistNodeModelHalo if case["table"] == "halo" else DistNodeModel
        model = cls(case["layer"], sg.x.shape[-1], case["hidden"], 2,
                    case["out_dim"],
                    classify=case["task"] == "classification",
                    dropout_rate=0.0)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in case["params"].items()})
        opt = adam_l2(model.parameters(), case["lr"], case["wd"])
        if case["table"] == "halo":
            step = make_halo_train_step(mesh, model, edges)
            losses = [float(step(opt, shard)) for _ in range(case["steps"])]
        else:
            step = make_dist_train_step(mesh, model)
            losses = [float(step(opt, shard, edges))
                      for _ in range(case["steps"])]
        loss, metric = make_dist_eval_step(mesh, model, "val")(shard, edges)
        return {"losses": losses, "eval": (float(loss), float(metric)),
                "params": _state(model)}
    res = {}
    for table, edges in tables.items():
        layer = make_dist_conv(case["layer"], sg.x.shape[-1],
                               case["hidden"], table == "halo")
        layer.load_state_dict({k: torch.from_numpy(v)
                               for k, v in case["params"].items()})
        x = shard.x.clone().requires_grad_()
        out = layer(x, edges.senders, edges.receivers, edges.edge_weight,
                    getattr(edges, "send_idx", None),
                    getattr(edges, "send_mask", None), mesh.chip_group)
        torch.tanh(out).sum().backward()
        all_reduce_grads(layer.parameters(), mesh.chip_group)
        res[table] = {"out": out.detach().numpy(), "x_grad": x.grad.numpy(),
                      "grads": {k: p.grad.numpy().copy()
                                for k, p in layer.named_parameters()}}
    # rows that name their shard and row: shard p's row j is p·1000 + j
    n_loc = sg.nodes_per_shard
    h = (rank * 1000 + torch.arange(n_loc, dtype=torch.float32))[:, None]
    lp = tables["halo"]
    res["halo_rows"] = halo_exchange(h.repeat(1, 3), lp.send_idx,
                                     lp.send_mask).numpy()
    model, _ = create_dist_state(
        DistNodeModel(case["layer"], sg.x.shape[-1], case["hidden"], 2, 3),
        case["seed"], "cpu")
    res["created"] = _state(model)
    return res


def run_case(case, mesh):
    rank = mesh.rank
    sg, rp = _plan(case, mesh)
    old = {k: os.environ.get(k) for k in case.get("env", {})}
    os.environ.update(case.get("env", {}))
    try:
        if case["kind"] in ("aggregate", "attention"):
            h = torch.from_numpy(sg.x[rank]).requires_grad_()
            if case["kind"] == "aggregate":
                out = hier_aggregate(h, rp)
            else:
                out = hier_attention_aggregate(
                    h, rp, torch.from_numpy(case["a_src"]),
                    torch.from_numpy(case["a_dst"]), 0.2)
            torch.tanh(out).sum().backward()
            return {"out": out.detach().numpy(), "grad": h.grad.numpy()}
        shard = sg.local(rank, "cpu")
        task = case["task"]
        model = HierNodeModel(case["layer"], in_dim=sg.x.shape[-1],
                              hidden=case["hidden"], num_layers=2,
                              out_dim=case["out_dim"],
                              classify=task == "classification",
                              dropout_rate=0.0)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in case["params"].items()})
        opt = adam_l2(model.parameters(), case["lr"], case["wd"])
        losses, grads = [], None
        for _ in range(case["steps"]):
            losses.append(float(hier_train_step(
                model, opt, shard.x, shard.y, shard.train_mask, rp, None,
                task)))
            if grads is None:     # the first step's summed gradients
                grads = {k: p.grad.numpy().copy()
                         for k, p in model.named_parameters()}
        loss, metric = hier_eval_step(model, shard.x, shard.y,
                                      shard.val_mask, rp, task)
        return {"losses": losses, "eval": (float(loss), float(metric)),
                "grads": grads,
                "params": {k: v.detach().numpy().copy()
                           for k, v in model.state_dict().items()}}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class World:
    """A gloo world of ``size`` worker processes running ``cases`` (a list
    of (name, case)), started at once; ``results(name)`` waits for every
    rank's result of that case (or for a rank to fail) and gives them."""

    def __init__(self, cases, tmp_dir, size: int = 4, timeout: float = 300):
        self.dir, self.size, self.timeout = str(tmp_dir), size, timeout
        spec = os.path.join(self.dir, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump(cases, f)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.logs = [open(os.path.join(self.dir, f"rank{r}.log"), "w")
                     for r in range(size)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(size),
             os.path.join(self.dir, "store"), spec, self.dir],
            stdout=log, stderr=subprocess.STDOUT, env=env)
            for r, log in enumerate(self.logs)]
        self.done = False

    def _failed(self, rcs):
        logs = "".join(
            open(os.path.join(self.dir, f"rank{r}.log")).read()[-3000:]
            for r in range(self.size))
        raise RuntimeError(f"gloo world failed (rcs {rcs}):\n{logs}")

    def wait(self):
        """Wait for the world to end; stop it after the timeout."""
        if self.done:
            return
        try:
            rcs = [p.wait(timeout=self.timeout) for p in self.procs]
        finally:
            for p in self.procs:
                p.kill()
            for log in self.logs:
                log.close()
            self.done = True
        if any(rcs):
            self._failed(rcs)

    def results(self, name):
        paths = [os.path.join(self.dir, f"{name}.{r}.pkl")
                 for r in range(self.size)]
        t0 = time.monotonic()
        while not all(map(os.path.exists, paths)):
            rcs = [p.poll() for p in self.procs]
            if any(rcs) or all(rc is not None for rc in rcs):
                self.wait()
                self._failed(rcs)
            if time.monotonic() - t0 > self.timeout:
                self.wait()
            time.sleep(0.05)
        out = []
        for path in paths:
            with open(path, "rb") as f:
                out.append(pickle.load(f))
        return out


def main(rank, world, store, spec, out):
    torch.set_num_threads(1)
    initialize_distributed(torch.device("cpu"), f"file://{store}", rank,
                           world)
    with open(spec, "rb") as f:
        cases = pickle.load(f)
    meshes = {}
    for name, case in cases:
        if case["kind"] in ("gs", "gc_eval", "run"):
            res = run_curriculum_case(case, rank, world)
        elif case["kind"] in ("flat_layers", "flat_train"):
            if "flat" not in meshes:
                meshes["flat"] = make_mesh()
            res = run_flat_case(case, meshes["flat"])
        else:
            hd = (case["H"], case["D"])
            if hd not in meshes:
                meshes[hd] = make_hier_mesh(*hd)
            res = run_case(case, meshes[hd])
        path = os.path.join(out, f"{name}.{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(path + ".tmp", path)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
