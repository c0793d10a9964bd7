"""The port's training path against the JAX package, on the CPU.

The same numpy inputs go through both packages.  The JAX Pallas kernels
run in interpret mode; the port's wrappers take their plain versions
because the tensors lie on the CPU.  Dropout streams differ between the
packages, so parity runs with ``dropout_rate=0`` (the JAX ConvStack then
takes ``nn.Dropout(0.0)``, an identity); the port's mask is tested for
its distribution and seeding.  Tolerances: losses and values within rtol
1e-4 and atol 1e-5·max(1, max|ref|), gradients within rtol 1e-4 and atol
1e-4·max(1, max|ref|) (f32 sums in another order); the optimizer within
rtol 1e-5 and atol 1e-7 on identical gradients.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fitgnn_tpu.graph.build import build_graph as jax_build_graph
from fitgnn_tpu.graph.optimize import \
    build_optimized_graph as jax_build_optimized_graph
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid
from fitgnn_tpu.ops.hybrid_spmm import hybrid_spmm as jax_hybrid_spmm
from fitgnn_tpu.train import losses as jax_losses
from fitgnn_tpu.train.steps import adam_l2 as jax_adam_l2
from fitgnn_tpu.utils import results as jax_results

from fitgnn_tpu_torch.cli.main import main
from fitgnn_tpu_torch.data.datasets import NodeDataset, save_npz_cache
from fitgnn_tpu_torch.graph.build import build_graph
from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.models.models import NodeModel, dropout
from fitgnn_tpu_torch.ops.bsr_spmm import bsr_spmm_acc
from fitgnn_tpu_torch.ops.coo_segmm import segmm_spmm
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid, hybrid_spmm
from fitgnn_tpu_torch.train import losses, steps
from fitgnn_tpu_torch.train.checkpoint import restore_params, save_params
from fitgnn_tpu_torch.utils import results

torch.set_num_threads(1)


def close(got, ref, grad=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=(1e-4 if grad else 1e-5) * scale)


def community_graph(rng, n, feat, deg=10, block=128, internal=0.85):
    e = n * deg
    r = rng.integers(0, n, e)
    s_in = np.minimum((r // block) * block + rng.integers(0, block, e), n - 1)
    s = np.where(rng.random(e) < internal, s_in, rng.integers(0, n, e))
    keep = s != r
    perm = rng.permutation(n)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    return x, perm[s[keep]], perm[r[keep]]


@pytest.mark.parametrize("use_segmm", [True, False])
def test_hybrid_spmm_grad_matches_jax(use_segmm):
    rng = np.random.default_rng(3)
    n, e = 1024, 9000
    r = np.sort(rng.integers(0, n, e))
    s = np.where(rng.random(e) < 0.8, (r // 128) * 128
                 + rng.integers(0, 128, e), rng.integers(0, n, e))
    w = rng.random(e).astype(np.float32)
    kw = dict(min_block_edges=40, use_segmm=use_segmm)
    ht, hj = build_hybrid(s, r, w, n, **kw), jax_build_hybrid(s, r, w, n, **kw)
    assert ht.bsr is not None and ht.num_coo_edges > 1
    x = rng.standard_normal((n, 16)).astype(np.float32)
    tgt = rng.standard_normal((n, 16)).astype(np.float32)
    dx_j = jax.grad(lambda xx: jnp.sum((jax_hybrid_spmm(hj, xx) - tgt) ** 2))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    ((hybrid_spmm(ht, xt) - torch.from_numpy(tgt)) ** 2).sum().backward()
    close(xt.grad, dx_j, grad=True)
    assert bsr_spmm_acc.launches == segmm_spmm.launches == 0


def test_hybrid_spmm_skips_backward_for_constant_input():
    rng = np.random.default_rng(4)
    s = rng.integers(0, 256, 500)
    r = np.sort(rng.integers(0, 256, 500))
    h = build_hybrid(s, r, np.ones(500, np.float32), 256, min_block_edges=4,
                     use_segmm=True)
    out = hybrid_spmm(h, torch.ones(256, 4))
    assert not out.requires_grad and out.grad_fn is None


def _graphs(layer, hybrid):
    rng = np.random.default_rng(11)
    n, f = 640, 16
    x, s, r = community_graph(rng, n, f)
    y = rng.integers(0, 4, n)
    mask = rng.random(n) < 0.5
    if hybrid:
        kw = dict(y=y, train_mask=mask, min_block_edges=80, layer_name=layer)
        gt, _ = build_optimized_graph(x, s, r, **kw)
        gj, _ = jax_build_optimized_graph(x, s, r, **kw)
        assert gt.aux.bsr is not None and gt.aux.num_coo_edges > 1
    else:
        gt = build_graph(x, s, r, y=y, train_mask=mask)
        gj = jax_build_graph(x, s, r, y=y, train_mask=mask)
    return gt, gj


def _grads_by_port_name(grads_tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, grads_tree))


@pytest.mark.parametrize("hybrid", [True, False])
@pytest.mark.parametrize("layer", ["GCNConv", "GATConv"])
def test_train_step_matches_jax(layer, hybrid):
    """One ``gc_train_step`` at hidden 32 (GAT's layer 0 aggregates on the
    narrow side of 16 → 32): the loss and every parameter gradient."""
    gt, gj = _graphs(layer, hybrid)
    jm = JaxNodeModel(layer_name=layer, hidden=32, num_layers=2, out_dim=4,
                      dropout_rate=0.0)
    # init on a tiny graph: the parameters depend only on the widths
    tiny = jax_build_graph(np.asarray(gj.x)[:8], np.arange(4), np.arange(4))
    params = jm.init(jax.random.PRNGKey(2), tiny.x, tiny)

    def loss_j(p):
        out = jm.apply(p, gj.x, gj, train=True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_losses.masked_nll(out, gj.y, gj.train_mask)

    loss_ref, grads = jax.value_and_grad(loss_j)(params)
    model = NodeModel(layer, 16, 32, 2, 4, dropout_rate=0.0)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, params)))
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    loss = steps.gc_train_step(model, opt, gt, gt.y, gt.train_mask, None,
                               "classification")
    close(loss, loss_ref)
    ref = _grads_by_port_name(grads)
    for name, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        close(p.grad, ref[name], grad=True)


def test_adam_l2_matches_optax():
    """Three updates on identical gradients: weight decay enters the
    gradient (biases too) before the moments."""
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    b0 = rng.standard_normal(3).astype(np.float32)
    gs = [(rng.standard_normal((4, 3)).astype(np.float32),
           rng.standard_normal(3).astype(np.float32)) for _ in range(3)]
    tx = jax_adam_l2(0.01, 5e-4)
    pj = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    state = tx.init(pj)
    w, b = torch.nn.Parameter(torch.tensor(w0)), torch.nn.Parameter(
        torch.tensor(b0))
    opt = steps.adam_l2([w, b], 0.01, 5e-4)
    for gw, gb in gs:
        upd, state = tx.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)},
                               state, pj)
        pj = optax.apply_updates(pj, upd)
        w.grad, b.grad = torch.tensor(gw), torch.tensor(gb)
        opt.step()
        for got, ref in ((w, pj["w"]), (b, pj["b"])):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-7)


def test_losses_match_jax():
    rng = np.random.default_rng(6)
    n, c = 50, 5
    logits = rng.standard_normal((n, c)).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    y = rng.integers(0, c, n)
    mask = rng.random(n) < 0.6
    pred = rng.standard_normal((n, 1)).astype(np.float32)
    tgt = rng.standard_normal(n).astype(np.float32)
    tl, ty, tm = torch.tensor(lp), torch.tensor(y), torch.tensor(mask)
    jl, jy, jm = jnp.asarray(lp), jnp.asarray(y), jnp.asarray(mask)
    for red in ("mean", "sum"):
        close(losses.masked_nll(tl, ty, tm, red),
              jax_losses.masked_nll(jl, jy, jm, red))
        close(losses.masked_l1(torch.tensor(pred), torch.tensor(tgt), tm, red),
              jax_losses.masked_l1(jnp.asarray(pred), jnp.asarray(tgt), jm,
                                   red))
    close(losses.masked_l1_std_normalized(torch.tensor(pred),
                                          torch.tensor(tgt), tm),
          jax_losses.masked_l1_std_normalized(jnp.asarray(pred),
                                              jnp.asarray(tgt), jm))
    close(losses.masked_accuracy(tl, ty, tm),
          jax_losses.masked_accuracy(jl, jy, jm))
    # no row selected: the count clamps to 1 instead of dividing by 0
    none = torch.zeros(n, dtype=torch.bool)
    assert float(losses.masked_nll(tl, ty, none)) == 0.0


def test_bit_dropout_mask():
    """Rate ½: about half the elements kept, scaled by 2; the same seed
    gives the same mask, another seed another one."""
    x = torch.ones(256, 512)
    a = dropout(x, 0.5, torch.Generator().manual_seed(0))
    b = dropout(x, 0.5, torch.Generator().manual_seed(0))
    c = dropout(x, 0.5, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert abs(float((a > 0).float().mean()) - 0.5) < 0.01
    d = dropout(x, 0.2, torch.Generator().manual_seed(0))
    assert abs(float((d > 0).float().mean()) - 0.8) < 0.01
    assert torch.allclose(d[d > 0], torch.full_like(d[d > 0], 1.25))
    assert torch.equal(dropout(x, 0.0, None), x)


def test_train_mode_dropout_needs_a_generator():
    rng = np.random.default_rng(8)
    x, s, r = community_graph(rng, 200, 8)
    g = build_graph(x, s, r)
    m = NodeModel("GCNConv", 8, 16, 2, 3).reset_parameters(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="Generator"):
        m.train()(g.x, g)
    a = m(g.x, g, torch.Generator().manual_seed(4))
    b = m(g.x, g, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    with torch.no_grad():
        e1, e2 = m.eval()(g.x, g), m(g.x, g)
    assert torch.equal(e1, e2) and not torch.equal(a.detach(), e1)


def test_checkpoint_round_trip(tmp_path):
    m = NodeModel("GATConv", 8, 16, 2, 3).reset_parameters(
        torch.Generator().manual_seed(0))
    path = str(tmp_path / "a" / "model.pt")
    save_params(path, m.state_dict())
    back = restore_params(path)
    assert back.keys() == m.state_dict().keys()
    for k, v in m.state_dict().items():
        assert torch.equal(back[k], v)


def test_train_headers_match_jax():
    assert results.TRAIN_NODE_CLS_HEADER == jax_results.TRAIN_NODE_CLS_HEADER
    assert results.TRAIN_NODE_REG_HEADER == jax_results.TRAIN_NODE_REG_HEADER


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """A 400-node, 4-class community dataset as an npz cache; the working
    directory is ``tmp_path`` so CSVs and checkpoints land there."""
    rng = np.random.default_rng(0)
    n = 400
    r = rng.integers(0, n, 3000)
    s = np.where(rng.random(3000) < 0.8,
                 np.minimum((r // 100) * 100 + rng.integers(0, 100, 3000),
                            n - 1), rng.integers(0, n, 3000))
    y = (np.arange(n) // 100).astype(np.int64)
    x = (rng.standard_normal((n, 12)) + y[:, None] * 0.5).astype(np.float32)
    os.makedirs(tmp_path / "dataset" / "toy")
    save_npz_cache(str(tmp_path / "dataset" / "toy" / "toy.npz"),
                   NodeDataset("toy", x, s, r, y))
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("layer,extra", [
    ("GCNConv", []), ("GATConv", []),
    ("GATConv", ["--hybrid_spmm", "on", "--hybrid_threshold", "8"])])
def test_train_baseline_then_infer_baseline(toy, layer, extra):
    """``train --baseline`` writes a CSV row under the JAX header and a
    checkpoint that ``infer-baseline`` serves."""
    common = ["--dataset", "toy", "--data_root", str(toy / "dataset"),
              "--layer_name", layer, "--hidden", "16", "--experiment",
              "random", "--device", "cpu"]
    assert main(["train", "--baseline", "--runs", "2", "--epochs1", "15",
                 *common, *extra]) == 0
    with open(toy / "results" / "baseline" / "toy.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == jax_results.TRAIN_NODE_CLS_HEADER and len(lines) == 2
    row = dict(zip(lines[0].split(","), lines[1].split(",")))
    assert row["exp_setup"] == "baseline" and row["layer_name"] == layer
    assert row["runs"] == "2" and float(row["best_acc"]) > 0.5
    ckpt = toy / "save" / "node_cls" / "baseline" / "out" / "model.pt"
    sd = restore_params(str(ckpt))
    assert all(torch.isfinite(v).all() for v in sd.values())
    assert main(["infer-baseline", "--num_test_samples", "32",
                 *common]) == 0
    with open(toy / "inference_results" / "node_cls.csv") as f:
        inf = dict(zip(*(line.split(",") for line in f.read().splitlines())))
    # trained weights (random ones score about 1/4 on 4 classes)
    assert float(inf["acc"]) > 0.4


def test_train_baseline_node_reg(toy):
    """Regression: masked L1 training, the JAX package's regression header,
    and the std-normalized L1 as the recorded loss."""
    assert main(["train", "--baseline", "--task", "node_reg", "--dataset",
                 "toy", "--data_root", str(toy / "dataset"), "--hidden", "16",
                 "--runs", "1", "--epochs1", "10", "--device", "cpu"]) == 0
    with open(toy / "results" / "baseline" / "toy.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == jax_results.TRAIN_NODE_REG_HEADER and len(lines) == 2
    row = dict(zip(lines[0].split(","), lines[1].split(",")))
    assert 0.0 < float(row["best_loss"]) < 1.0     # below the std of y
    assert (toy / "save" / "node_reg" / "baseline" / "out" /
            "model.pt").exists()


@pytest.mark.parametrize("flags", [
    ["--baseline", "--resume"],
    ["--baseline", "--checkpoint_every", "5"]])
def test_unported_train_options_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["train", "--dataset", "toy", *flags])


def test_train_baseline_graph_task_runs_graph_path(tmp_path, monkeypatch):
    """``train --baseline --task graph_reg`` takes the graph path, as the
    JAX package's ``cmd_train`` does (it branches on the task first): a
    TRAIN_GRAPH_HEADER row and the graph checkpoint, no baseline one."""
    from fitgnn_tpu_torch.data.datasets import GraphDataset, save_graph_cache
    from fitgnn_tpu_torch.data.synthetic import qm9_like_dataset
    graphs, y_reg, _ = qm9_like_dataset(24, seed=0)
    os.makedirs(tmp_path / "dataset" / "qm")
    save_graph_cache(str(tmp_path / "dataset" / "qm" / "qm_graphs.npz"),
                     GraphDataset("qm", graphs, y_reg))
    monkeypatch.chdir(tmp_path)
    assert main(["train", "--baseline", "--task", "graph_reg", "--dataset",
                 "qm", "--data_root", str(tmp_path / "dataset"), "--hidden",
                 "8", "--epochs1", "3", "--exp_setup", "Gc_train_2_Gc_infer",
                 "--device", "cpu"]) == 0
    with open(tmp_path / "results" / "qm.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == jax_results.TRAIN_GRAPH_HEADER and len(lines) == 2
    row = dict(zip(lines[0].split(","), lines[1].split(",")))
    assert row["exp_setup"] == "Gc_train_2_Gc_infer"
    assert np.isfinite(float(row["best_test_loss"]))
    assert (tmp_path / "save" / "graph_reg" / "out" / "model.pt").exists()
    assert not (tmp_path / "save" / "graph_reg" / "baseline").exists()
    # infer-baseline on a graph task serves train's checkpoint, as infer
    assert main(["infer-baseline", "--task", "graph_reg", "--dataset", "qm",
                 "--data_root", str(tmp_path / "dataset"), "--hidden", "8",
                 "--num_test_samples", "4", "--device", "cpu"]) == 0
    with open(tmp_path / "inference_results" / "graph_reg.csv") as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    assert [r[3] for r in rows] == ["fitgnn_gs", "fitgnn_gc"]


# the cluster flags' refusals, raised before any data is read, with the JAX
# package's messages
@pytest.mark.parametrize("flags,message", [
    (["--cluster_attention_exact", "4"], "requires --cluster_attention"),
    (["--baseline", "--cluster_aggregation_exact", "4"],
     "requires --cluster_aggregation"),
    (["--baseline", "--cluster_attention", "128"], "GATConv only"),
    (["--cluster_aggregation", "128", "--layer_name", "GATConv"],
     "static-weight"),
    (["--baseline", "--cluster_aggregation", "128", "--task", "graph_cls"],
     "not graph-level tasks"),
    (["--cluster_aggregation", "128", "--exp_setup", "Gs_train_2_Gs_infer"],
     "Gc full-graph phase")])
def test_cluster_flags_refused_as_jax(flags, message):
    from fitgnn_tpu.cli import main as jax_cli
    argv = ["train", "--dataset", "nowhere", *flags]
    with pytest.raises(SystemExit, match=message) as got:
        main(argv)
    with pytest.raises(SystemExit) as ref:
        jax_cli.cmd_train(jax_cli.arg_correction(
            jax_cli.build_parser().parse_args(argv)))
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("flags", [
    ["--layer_name", "GATConv", "--cluster_attention", "128"],
    ["--layer_name", "GATConv", "--cluster_attention", "128",
     "--cluster_attention_exact", "8"],
    ["--cluster_aggregation", "128"],
    ["--cluster_aggregation", "128", "--cluster_aggregation_exact", "8"],
    ["--layer_name", "SAGEConv", "--cluster_aggregation", "256"],
    ["--auto_config"], ["--layer_name", "GATConv", "--auto_config"]])
def test_train_baseline_collapse_and_auto_config(toy, capsys, flags):
    """``train --baseline`` on the toy dataset (400 nodes, under the hybrid
    gate's 65,536): a collapse forces the hybrid operator and prints its
    table's entries; ``--auto_config`` takes the planner's threshold.  A
    finite row and a checkpoint either way."""
    assert main(["train", "--baseline", "--dataset", "toy", "--data_root",
                 str(toy / "dataset"), "--hidden", "16", "--runs", "1",
                 "--epochs1", "8", "--experiment", "random", "--device",
                 "cpu", *flags]) == 0
    out = capsys.readouterr().out
    if "--auto_config" in flags:
        assert "auto-config: tile threshold deferred to planner" in out
    else:
        k = flags[flags.index("--cluster_aggregation" if
                              "--cluster_aggregation" in flags
                              else "--cluster_attention") + 1]
        kind = "aggregation" if "--cluster_aggregation" in flags \
            else "attention"
        assert f"cluster-{kind} entries (K={k}, approximate)" in out
    with open(toy / "results" / "baseline" / "toy.csv") as f:
        lines = f.read().splitlines()
    row = dict(zip(lines[0].split(","), lines[1].split(",")))
    assert np.isfinite(float(row["best_loss"]))
    assert (toy / "save" / "node_cls" / "baseline" / "out" /
            "model.pt").exists()
