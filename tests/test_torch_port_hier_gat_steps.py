"""The port's hierarchical train and eval steps against the JAX package's
for GAT (the interior on the tile attention, halo and summary edges in the
same softmax) at (H, D) = (1, 4) and (2, 2), and for GCN regression at
(2, 2) (``torch_port_hier_cases.py`` holds the cases and the
tolerances)."""

import pytest
import torch

from torch_port_hier_cases import check_steps, name_of, start_world

torch.set_num_threads(1)

CONFIGS = [("GATConv", "classification", 1, 4),
           ("GATConv", "classification", 2, 2),
           ("GCNConv", "regression", 2, 2)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = start_world(CONFIGS, tmp_path_factory.mktemp("hier_gat_steps"))
    yield w
    w.wait()


@pytest.mark.parametrize("cfg", CONFIGS, ids=name_of)
def test_hier_steps_match_jax(world, cfg):
    check_steps(world, cfg)
