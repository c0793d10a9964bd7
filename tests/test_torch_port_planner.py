"""The ingest planner (``graph/planner.py``), ``min_block_edges="auto"`` and
``--auto_config`` against the JAX package, on the CPU.

The planner's structure is the JAX package's and its rates and priors are
the H100's: with the JAX package's rates and priors set in the port's
module, ``tile_histogram``, ``predict_cost_ms`` and ``plan_config`` equal
the JAX package's on ``tests/test_planner.py``'s community fixture in
every mode; under the port's own rates the tests hold the structure
(monotonicity under the collapse, K snapping, the operational defaults).
``min_block_edges="auto"`` runs through both optimize functions, and
``_apply_auto_config`` sets the knobs as the JAX package's does on every
subcommand, where ``infer`` used to accept the flag and ignore it.
Costs within rtol 1e-12 (the same float64 sums); the rest exactly.
"""

import argparse
import types

import numpy as np
import pytest
import torch

from fitgnn_tpu.cli import main as jax_cli
from fitgnn_tpu.data.synthetic import sbm_graph
from fitgnn_tpu.graph import planner as jax_planner
from fitgnn_tpu.graph.optimize import \
    build_optimized_graph as jax_build_optimized_graph
from fitgnn_tpu.graph.optimize import optimize_coarse as jax_optimize_coarse

from fitgnn_tpu_torch.cli import main as cli
from fitgnn_tpu_torch.graph import planner
from fitgnn_tpu_torch.graph.optimize import (build_optimized_graph,
                                             optimize_coarse)

from test_planner import community_graph_edges
from test_torch_port_curriculum import partitions

torch.set_num_threads(1)

RATES = ("COST_TILE", "COST_EDGE_STATIC", "COST_EDGE_ATT",
         "COST_EDGE_COLLAPSED", "COST_TABLE_COL")
# the JAX package's tie-break priors, hard-coded in its plan_config
JAX_PRIORS = {"PRIOR_STATIC": 48, "PRIOR_ATT": 32, "PRIOR_COLLAPSED": 192}


@pytest.fixture(scope="module")
def edges():
    return community_graph_edges()


@pytest.fixture
def jax_rates(monkeypatch):
    """The JAX package's rates and priors in the port's module."""
    for k in RATES:
        monkeypatch.setattr(planner, k, getattr(jax_planner, k))
    for k, v in JAX_PRIORS.items():
        monkeypatch.setattr(planner, k, v)


def test_tile_histogram_matches_jax(edges):
    s, r = edges
    np.testing.assert_array_equal(planner.tile_histogram(s, r, 25_600),
                                  jax_planner.tile_histogram(s, r, 25_600))
    assert planner.THRESHOLD_CANDIDATES == jax_planner.THRESHOLD_CANDIDATES


@pytest.mark.parametrize("mode", [(False, 0), (True, 0), (False, 2048),
                                  (False, 512), (True, 2048)])
def test_predict_cost_matches_jax(edges, jax_rates, mode):
    s, r = edges
    counts = jax_planner.tile_histogram(s, r, 25_600)
    attention, k = mode
    for t in planner.THRESHOLD_CANDIDATES:
        np.testing.assert_allclose(
            planner.predict_cost_ms(counts, t, attention, k, 25_600),
            jax_planner.predict_cost_ms(counts, t, attention, k, 25_600),
            rtol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(layer_name="GCNConv"), dict(layer_name="GATConv"),
    dict(layer_name="SAGEConv"),
    dict(layer_name="GCNConv", cluster=2048),
    dict(layer_name="GATConv", cluster=2048),
    dict(layer_name="GCNConv", cluster=384),
    dict(layer_name="GCNConv", cluster=1280),
    dict(layer_name="GCNConv", n=2_500_000, num_subgraphs=80_000),
    dict(layer_name="GATConv", n=1_000_000),
    dict(layer_name="GCNConv", num_subgraphs=50_000)])
def test_plan_config_matches_jax_under_its_rates(edges, jax_rates, kw):
    """Every field of the plan, the alternatives included: the exact modes,
    the collapse at K 2048 and at K that do not divide 25,600 (snapped),
    and the big-graph knobs."""
    s, r = edges
    kw = dict(kw)
    n = kw.pop("n", 25_600)
    got = planner.plan_config(s, r, n, **kw)
    ref = jax_planner.plan_config(s, r, n, **kw)
    for f in ("min_block_edges", "block", "cluster_k", "dense_cutoff",
              "max_buckets", "chunk_budget"):
        assert getattr(got, f) == getattr(ref, f), f
    np.testing.assert_allclose(got.predicted_ms, ref.predicted_ms,
                               rtol=1e-12)
    assert got.alternatives.keys() == ref.alternatives.keys()
    np.testing.assert_allclose(list(got.alternatives.values()),
                               list(ref.alternatives.values()), rtol=1e-12)


def test_rates_are_the_cards_own():
    """No rate or prior of the JAX package's (the TPU's) stands in the
    port's module; every rate is a cost (0 or above)."""
    for k in RATES:
        assert getattr(planner, k) != getattr(jax_planner, k), k
        assert getattr(planner, k) >= 0, k
    assert (planner.PRIOR_STATIC, planner.PRIOR_ATT) != (48, 32)
    for k in JAX_PRIORS:
        assert getattr(planner, k) in planner.THRESHOLD_CANDIDATES


class TestStructureUnderTheCardsRates:
    def test_collapse_cost_falls_as_tiles_shed(self, edges):
        """Under the collapse a higher threshold only sheds tiles: the cost
        never rises with it."""
        s, r = edges
        counts = planner.tile_histogram(s, r, 25_600)
        costs = [planner.predict_cost_ms(counts, t, False, 2048, 25_600)
                 for t in planner.THRESHOLD_CANDIDATES]
        assert all(b <= a + 1e-12 for a, b in zip(costs, costs[1:]))
        # the collapsed stragglers cost less than the exact ones
        exact = [planner.predict_cost_ms(counts, t, False, 0, 25_600)
                 for t in planner.THRESHOLD_CANDIDATES]
        table = planner.predict_cost_ms(counts, 10 ** 9, False, 2048,
                                        25_600)
        assert all(c - table <= e + 1e-12 for c, e in zip(costs, exact))

    @pytest.mark.parametrize("cluster", [384, 2048, 12_800, 25_600])
    def test_k_snaps_to_a_128_multiple_divisor(self, edges, cluster):
        s, r = edges
        p = planner.plan_config(s, r, 25_600, cluster=cluster)
        assert p.cluster_k % 128 == 0 and 25_600 % p.cluster_k == 0
        assert p.cluster_k <= cluster
        assert p.cluster_k == max(k for k in range(128, cluster + 1, 128)
                                  if 25_600 % k == 0)

    def test_defaults_and_knobs(self, edges):
        s, r = edges
        p = planner.plan_config(s, r, 25_600)
        assert isinstance(p, planner.PlanConfig)
        assert p.block == 128 and p.dense_cutoff == 512
        assert p.max_buckets == 0 and p.chunk_budget == 1 << 28
        assert p.min_block_edges in planner.THRESHOLD_CANDIDATES
        assert p.predicted_ms == min(p.alternatives.values()) or \
            p.predicted_ms <= 1.02 * min(p.alternatives.values()) + 1e-12
        big = planner.plan_config(s, r, 2_500_000, num_subgraphs=80_000)
        assert big.max_buckets == 2 and big.chunk_budget == 1 << 26

    @pytest.mark.parametrize("layer,cluster", [("GCNConv", 0),
                                               ("GATConv", 0),
                                               ("GCNConv", 2048)])
    def test_tie_break_toward_the_prior(self, edges, layer, cluster):
        """The pick is the plateau's threshold nearest the mode's prior."""
        s, r = edges
        p = planner.plan_config(s, r, 25_600, layer_name=layer,
                                cluster=cluster)
        best = min(p.alternatives.values())
        plateau = [t for t, c in p.alternatives.items()
                   if c <= best * 1.02 + 1e-12]
        prior = (planner.PRIOR_COLLAPSED if cluster else planner.PRIOR_ATT
                 if layer == "GATConv" else planner.PRIOR_STATIC)
        assert p.min_block_edges == min(plateau, key=lambda t: abs(t - prior))


# ---- min_block_edges="auto" ---------------------------------------------------

@pytest.mark.parametrize("kw", [dict(layer_name="GCNConv"),
                                dict(layer_name="GATConv"),
                                dict(layer_name="GCNConv", cluster_agg=256)])
def test_build_optimized_graph_auto_matches_jax(jax_rates, capsys, kw):
    """Under the JAX package's rates both packages pick the same threshold
    for the reordered graph's real edges and build the same operator; the
    line printed is the JAX package's."""
    x, s, r, y = sbm_graph(num_nodes=400, num_classes=3, num_features=8,
                           p_in=0.1, p_out=0.01, seed=0)
    gt, ot = build_optimized_graph(x, s, r, y=y, min_block_edges="auto",
                                   **kw)
    out_t = capsys.readouterr().out
    gj, oj = jax_build_optimized_graph(x, s, r, y=y, min_block_edges="auto",
                                       **kw)
    out_j = capsys.readouterr().out
    np.testing.assert_array_equal(ot, oj)
    assert out_t == out_j and out_t.startswith("auto-config: tile threshold")
    assert gt.aux.num_coo_edges == gj.aux.num_coo_edges
    assert (gt.aux.bsr is None) == (gj.aux.bsr is None)
    if gj.aux.bsr is not None:
        np.testing.assert_array_equal(gt.aux.bsr.rows.numpy(),
                                      np.asarray(gj.aux.bsr.rows))


def test_optimize_coarse_auto_matches_jax(jax_rates, capsys):
    part, jpart = partitions()
    ct = optimize_coarse(part.coarse, min_block_edges="auto")
    out_t = capsys.readouterr().out
    cj = jax_optimize_coarse(jpart.coarse, min_block_edges="auto")
    out_j = capsys.readouterr().out
    assert out_t == out_j and "auto-config: tile threshold" in out_t
    assert ct.graph.aux.num_coo_edges == cj.graph.aux.num_coo_edges
    np.testing.assert_array_equal(ct.graph.senders.numpy(),
                                  np.asarray(cj.graph.senders))


def test_auto_threshold_under_the_cards_rates(capsys):
    """Under the port's own rates ``"auto"`` runs, picks a candidate and
    builds with it."""
    x, s, r, y = sbm_graph(num_nodes=400, num_classes=3, num_features=8,
                           p_in=0.1, p_out=0.01, seed=0)
    g, _ = build_optimized_graph(x, s, r, y=y, min_block_edges="auto")
    t = int(capsys.readouterr().out.split("threshold ")[1].split()[0])
    assert t in planner.THRESHOLD_CANDIDATES
    ref, _ = build_optimized_graph(x, s, r, y=y, min_block_edges=t)
    assert g.aux.num_coo_edges == ref.aux.num_coo_edges


# ---- --auto_config ------------------------------------------------------------

ARGV = {"train": ["train"], "train --baseline": ["train", "--baseline"],
        "infer": ["infer"], "infer-baseline": ["infer-baseline"]}


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("num_nodes", [1_000, 120_000, 1_200_000])
@pytest.mark.parametrize("command", list(ARGV))
def test_apply_auto_config_matches_jax(capsys, command, num_nodes, bucket):
    """The port's ``_apply_auto_config`` and the JAX package's on each
    package's parse of the same command line: the same namespace after
    (threshold "auto" on train alone; 2 buckets and 1<<26 elements at
    120,000 and 1,200,000 nodes, the bucket cap under --bucket_sizes
    alone) and the same line printed."""
    argv = [*ARGV[command], "--auto_config", "--dataset", "toy",
            *(["--bucket_sizes"] if bucket else [])]
    got = cli.build_parser().parse_args(argv)
    ref = jax_cli.build_parser().parse_args(argv)
    cli._apply_auto_config(got, num_nodes)
    out_t = capsys.readouterr().out
    jax_cli._apply_auto_config(ref, num_nodes)
    assert capsys.readouterr().out == out_t
    names = ("hybrid_threshold", "max_buckets", "chunk_budget")
    assert {k: getattr(got, k, None) for k in names} == \
        {k: getattr(ref, k, None) for k in names}
    big = num_nodes > 1_000
    assert getattr(got, "max_buckets") == (2 if big and bucket else 0)
    assert getattr(got, "chunk_budget", None) == (
        1 << 26 if big else (1 << 28 if command.startswith("train")
                             else None))
    assert getattr(got, "hybrid_threshold", None) == (
        "auto" if command.startswith("train") else None)
    plain = cli.build_parser().parse_args(argv[:-1] if bucket else argv)
    plain.auto_config = False
    before = vars(plain).copy()
    cli._apply_auto_config(plain, num_nodes)
    assert vars(plain) == before


class _Stop(Exception):
    pass


def _knobs_at_partition(monkeypatch, module, argv, run):
    """The bucket cap and chunk budget that reach ``_partition`` when
    ``run`` runs ``argv``, on a dataset that reports 120,000 nodes (the
    partition is not run)."""
    seen = {}

    def fake_partition(args, *rest):
        seen.update(max_buckets=args.max_buckets,
                    chunk_budget=getattr(args, "chunk_budget", None))
        raise _Stop

    ds = types.SimpleNamespace(num_nodes=120_000, num_classes=3,
                               x=np.zeros((1, 8), np.float32),
                               y=np.zeros(1, np.int32))
    monkeypatch.setattr(module, "_load_node", lambda args: ds)
    monkeypatch.setattr(module, "_splits", lambda *a: (None, None, None))
    monkeypatch.setattr(module, "_partition", fake_partition)
    with pytest.raises(_Stop):
        run(argv)
    return seen


def test_infer_auto_config_partitions_as_jax(monkeypatch):
    """``infer --auto_config --bucket_sizes`` on 120,000 nodes (ratio 0.5:
    about 60,000 subgraphs) partitions with 2 buckets and 1<<26 elements,
    as the JAX package's ``cmd_infer`` does (the port used to take the
    flag and partition uncapped, under another cache key)."""
    argv = ["infer", "--auto_config", "--bucket_sizes", "--dataset", "toy",
            "--experiment", "random"]
    got = _knobs_at_partition(monkeypatch, cli, [*argv, "--device", "cpu"],
                              cli.main)
    ref = _knobs_at_partition(
        monkeypatch, jax_cli, argv,
        lambda a: jax_cli.cmd_infer(jax_cli.build_parser().parse_args(a)))
    assert got == ref == {"max_buckets": 2, "chunk_budget": 1 << 26}


def test_train_auto_config_reaches_the_gc_phase(monkeypatch):
    """``train --auto_config``: the partition sees the knobs and the Gc
    phase's ``optimize_coarse`` the planner's ``"auto"``."""
    argv = ["train", "--auto_config", "--bucket_sizes", "--dataset", "toy",
            "--experiment", "random", "--device", "cpu"]
    got = _knobs_at_partition(monkeypatch, cli, argv, cli.main)
    assert got == {"max_buckets": 2, "chunk_budget": 1 << 26}
    args = argparse.Namespace(auto_config=True, hybrid_threshold=48,
                              coarsening_ratio=0.5)
    cli._apply_auto_config(args, 10)
    assert args.hybrid_threshold == "auto"
