"""The port's hierarchical train and eval steps against the JAX package's
on one host of four chips, (H, D) = (1, 4): GCN, SAGE and GIN for
classification (``torch_port_hier_cases.py`` holds the cases and the
tolerances; the port runs in one gloo world of 4 ranks, started once the
JAX parameters exist and running while the JAX steps compile)."""

import pytest
import torch

from torch_port_hier_cases import check_steps, name_of, start_world

torch.set_num_threads(1)

CONFIGS = [(layer, "classification", 1, 4)
           for layer in ("GCNConv", "SAGEConv", "GINConv")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = start_world(CONFIGS, tmp_path_factory.mktemp("hier_steps14"))
    yield w
    w.wait()


@pytest.mark.parametrize("cfg", CONFIGS, ids=name_of)
def test_hier_steps_match_jax(world, cfg):
    check_steps(world, cfg)
