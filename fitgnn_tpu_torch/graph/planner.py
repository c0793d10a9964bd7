"""Ingest planner: the hybrid operator's tile threshold (and the cluster
size and the pipeline knobs) from the graph's structure, as the JAX
package's ``graph/planner.py`` picks them, with rates measured on the
port's card.

The model prices one training step's hybrid work at a threshold t:

    cost(t) = a · T(t) + b · E_coo(t) + cluster terms

where T(t) is the number of 128×128 tiles with at least t edges and
E_coo(t) the edges left in the other tiles (the stragglers), both from the
graph's tile histogram (one ``np.unique`` pass).  Under the cluster
collapse the stragglers cost ``COST_EDGE_COLLAPSED`` an edge (the (N, C)
table's build and product do not follow them) plus ``COST_TABLE_COL`` for
each (128-row, 1-column) slab of the (N, C) table.

The rates were fitted by ``scripts/torch_planner_sweep.py`` on one NVIDIA
H100 80GB HBM3 at a 700.00 W power limit (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``), torch 2.11.0+cu128:
``gc_train_step`` of a 2-layer model at hidden 512 on the 169,344-node
bench graph, timed with CUDA events (10 steps after 3 warm-ups) at every
threshold in ``THRESHOLD_CANDIDATES``, then least squares with an
intercept and the rates held at 0 or above: ``COST_TILE`` and
``COST_EDGE_STATIC`` from exact GCN, ``COST_EDGE_ATT`` from exact GAT (its
default switches) given ``COST_TILE``, ``COST_EDGE_COLLAPSED`` and
``COST_TABLE_COL`` from GCN under ``cluster_agg`` 2048 and 512 (the
collapsed edges' rate sits at its bound: the collapsed stragglers add
nothing the step time shows).  On that card a straggler edge costs under a
thousandth of a tile, so the static threshold is higher than the JAX
package's.  The priors that break ties on a flat cost are the fastest
thresholds that sweep measured for each mode.

The pipeline knobs (``max_buckets``, ``chunk_budget``) keep the JAX
package's values, so that ``--auto_config`` partitions and keys the cache
as it does; they were not measured on this card.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BLOCK = 128
# fitted rates, seconds (see the module docstring)
COST_TILE = 1.907e-7                 # a dense tile, one step
COST_EDGE_STATIC = 1.376e-10         # a straggler edge, static weights
COST_EDGE_ATT = 2.501e-9             # a straggler edge, attention
COST_EDGE_COLLAPSED = 0.0            # a collapsed straggler edge
COST_TABLE_COL = 5.456e-9            # a (128-row, 1-column) slab of (N, C)

# the fastest measured threshold of each mode: the tie-break on a flat cost
PRIOR_STATIC = 256
PRIOR_ATT = 96
PRIOR_COLLAPSED = 192

THRESHOLD_CANDIDATES = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384)


@dataclasses.dataclass
class PlanConfig:
    min_block_edges: int             # hybrid tile threshold
    block: int = BLOCK               # the port's tiles are 128 wide
    cluster_k: int = 0               # collapse cluster size (0 = exact)
    dense_cutoff: int = 512          # Gs dense-adjacency branch
    max_buckets: int = 0             # 0 = pipeline default
    chunk_budget: int = 1 << 28      # MB/eval chunk element budget
    predicted_ms: float = 0.0        # cost-model estimate for the choice
    alternatives: dict = dataclasses.field(default_factory=dict)


def tile_histogram(senders: np.ndarray, receivers: np.ndarray,
                   num_nodes_padded: int, block: int = BLOCK) -> np.ndarray:
    """Sorted per-tile edge counts (descending) for the 128x128 grid."""
    nb = num_nodes_padded // block
    tile = (np.asarray(receivers, np.int64) // block) * nb \
        + (np.asarray(senders, np.int64) // block)
    _, counts = np.unique(tile, return_counts=True)
    return np.sort(counts)[::-1]


def predict_cost_ms(counts_desc: np.ndarray, threshold: int,
                    attention: bool, cluster_k: int,
                    num_nodes_padded: int) -> float:
    """Cost-model step time (ms) for one hybrid split choice."""
    dense = counts_desc >= threshold
    n_tiles = int(dense.sum())
    e_coo = int(counts_desc[~dense].sum())
    cost = COST_TILE * n_tiles
    if cluster_k:
        c_cols = num_nodes_padded // cluster_k
        cost += COST_EDGE_COLLAPSED * e_coo
        cost += COST_TABLE_COL * (num_nodes_padded / 128) * c_cols
    else:
        cost += (COST_EDGE_ATT if attention else COST_EDGE_STATIC) * e_coo
    return cost * 1e3


def plan_config(senders: np.ndarray, receivers: np.ndarray,
                num_nodes_padded: int, layer_name: str = "GCNConv",
                cluster: int = 0, num_subgraphs: int = 0,
                hidden: int = 512) -> PlanConfig:
    """Pick {tile threshold, block, K, bucket cap, chunk budget} for one
    graph.  ``cluster`` > 0 requests the collapse (value = suggested K;
    snapped to a 128-multiple divisor of the padded node count)."""
    attention = layer_name == "GATConv"
    counts = tile_histogram(senders, receivers, num_nodes_padded)

    k = 0
    if cluster:
        k = int(cluster)
        if num_nodes_padded % k:
            divs = [128 * d for d in range(1, num_nodes_padded // 128 + 1)
                    if (num_nodes_padded // 128) % d == 0 and 128 * d <= k]
            k = max(divs) if divs else 128
    alts = {t: predict_cost_ms(counts, t, attention, k, num_nodes_padded)
            for t in THRESHOLD_CANDIDATES}
    best_cost = min(alts.values())
    # flat cost regions are common (community tiles sit far above every
    # candidate, scattered tiles far below): within the 2% plateau,
    # tie-break toward the measured champion of the mode
    prior = PRIOR_COLLAPSED if k else (PRIOR_ATT if attention
                                       else PRIOR_STATIC)
    plateau = [t for t, c in alts.items() if c <= best_cost * 1.02 + 1e-12]
    best_t = min(plateau, key=lambda t: abs(t - prior))

    n_big = num_nodes_padded >= 1_000_000 or num_subgraphs >= 50_000
    return PlanConfig(
        min_block_edges=best_t,
        cluster_k=k,
        max_buckets=2 if n_big else 0,
        chunk_budget=(1 << 26) if n_big else (1 << 28),
        predicted_ms=alts[best_t],
        alternatives=alts)
