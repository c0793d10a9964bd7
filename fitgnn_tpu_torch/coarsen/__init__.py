"""Graph coarsening (host numpy/scipy): the port's copy of the JAX
package's ``fitgnn_tpu/coarsen/``, with the native cores built into
``build/fitgnn_tpu_torch/`` and no networkx."""

from fitgnn_tpu_torch.coarsen.core import coarsen, CoarseningResult, METHODS
from fitgnn_tpu_torch.coarsen.lapgraph import LapGraph, connected_components
from fitgnn_tpu_torch.coarsen.project import (
    coarsening_matrix, membership_matrix, coarsen_weights, coarsen_features,
    coarse_labels_and_masks, lift_vector, partition_from_contractions,
    compose_partitions,
)
from fitgnn_tpu_torch.coarsen.quality import (eigenvalue_errors,
                                              rayleigh_preservation)

__all__ = [
    "coarsen", "CoarseningResult", "METHODS", "LapGraph",
    "connected_components", "coarsening_matrix", "membership_matrix",
    "coarsen_weights", "coarsen_features", "coarse_labels_and_masks",
    "lift_vector", "partition_from_contractions", "compose_partitions",
    "eigenvalue_errors", "rayleigh_preservation",
]
