"""GAT's bf16 compute dtype against the JAX package, on the CPU:
``NodeModel("GATConv", ..., dtype=torch.bfloat16)`` against the JAX
``NodeModel(dtype=jnp.bfloat16)`` two-stage (K4, K4ᵀ and K5 through their
widened route) and fused with K6 (``FITGNN_GAT_FUSED_TILES=1
FITGNN_GAT_SEGMM_DEN=1``: K7 widened, K6 and K3w's bf16-activation form),
on f32 and bf16 tiles.  The checks and tolerances are
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
}


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_gat_model_matches_jax(monkeypatch, case):
    check_case(monkeypatch, *CASES[case])
