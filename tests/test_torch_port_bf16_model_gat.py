"""GAT's bf16 compute dtype against the JAX package, on the CPU:
``NodeModel("GATConv", ..., dtype=torch.bfloat16)`` against the JAX
``NodeModel(dtype=jnp.bfloat16)`` two-stage (K4a, K4ᵀa and K5a, the
dynamic tiles' bf16-activation forms) and fused with K6
(``FITGNN_GAT_FUSED_TILES=1 FITGNN_GAT_SEGMM_DEN=1``: K7 widened, K6 and
K3w's bf16-activation form), on f32 and bf16 tiles; and bench.py's bf16
GAT configuration cut to this size (bf16 tiles, ``use_segmm``, the
two-stage path) at tile edge 128 with bench.py's GAT threshold 32 and at
edge 256 with threshold 48.  The checks and tolerances are
``tests/test_torch_port_bf16_model.py``'s (``check_case``), ``att_dst``'s
gradient held against the f32 gradient as its note says.
"""

import pytest
import torch

from test_torch_port_bf16_model import check_case

torch.set_num_threads(1)

FUSED = {"FUSED_TILES": True, "SEGMM_DEN": True}
CASES = {
    "gat": ("GATConv", False, False, {}),
    "gat_bftiles": ("GATConv", True, False, {}),
    "gat_fused_den": ("GATConv", False, False, FUSED),
    "gat_fused_den_bftiles": ("GATConv", True, False, FUSED),
    # bench.py's GAT configuration: (block, min_block_edges) beside
    "gat_bench": ("GATConv", True, False, {}, 128, 32),
    "gat_bench_edge256": ("GATConv", True, False, {}, 256, 48),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_gat_model_matches_jax(monkeypatch, case):
    check_case(monkeypatch, *CASES[case])
