"""Minimal host-side weighted-graph container for the coarsening stack.

Replaces the reference's pygsp ``Graph`` dependency (``coarsening_utils.py:4``)
with plain scipy CSR + cached Laplacian/degree views.  Everything here runs at
ingest time on the host; nothing touches the device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class LapGraph:
    """Undirected weighted graph: symmetric W (csr, zero diagonal)."""

    def __init__(self, W: sp.spmatrix):
        W = sp.csr_matrix(W)
        W = W - sp.diags(W.diagonal())
        W.eliminate_zeros()
        # enforce symmetry (tiny numeric asymmetries averaged out)
        W = (W + W.T) * 0.5
        self.W = sp.csr_matrix(W)
        self.N = W.shape[0]
        self.dw = np.asarray(self.W.sum(axis=1)).ravel()  # weighted degrees

    @property
    def L(self) -> sp.csr_matrix:
        if not hasattr(self, "_L"):
            self._L = sp.csgraph.laplacian(self.W).tocsr()
        return self._L

    def edge_list(self):
        """Upper-triangular edge list (i < j) + weights."""
        coo = sp.triu(self.W, k=1).tocoo()
        return coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data

    @property
    def num_edges(self) -> int:
        return sp.triu(self.W, k=1).nnz

    def neighborhoods(self):
        """List of closed neighborhoods (node + its neighbors), per node."""
        indptr, indices = self.W.indptr, self.W.indices
        return [np.append(indices[indptr[i]:indptr[i + 1]], i)
                for i in range(self.N)]


def connected_components(W: sp.spmatrix):
    """Connected components sorted by size (desc): list of node-index arrays.

    Replaces pygsp ``extract_components`` + the reference's size sort
    (``utils.py:144-158``).
    """
    n_comp, labels = sp.csgraph.connected_components(W, directed=False)
    comps = [np.where(labels == c)[0] for c in range(n_comp)]
    comps.sort(key=len, reverse=True)
    return comps
