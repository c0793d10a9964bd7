"""Coarsening visualizer (the reference's ``plot_coarsening``): draw each
level's graph with the contracted groups coloured.  A debug tool, not used
by the pipeline.

The JAX package lays the finest level out with networkx's
``spring_layout(seed=0)``.  The port has no networkx, so ``spring_layout``
below is its copy of that layout for a graph made from ``W``
(``from_scipy_sparse_array``): below 500 nodes the dense
Fruchterman–Reingold iteration, from 500 the energy form that networkx
minimises with scipy's L-BFGS-B; both from ``RandomState(0)``'s initial
positions, then rescaled to [-1, 1] as networkx rescales them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import scipy.sparse as sp


def _adjacency(W: sp.spmatrix) -> np.ndarray:
    """The dense symmetric adjacency networkx reads from the graph
    ``from_scipy_sparse_array(W)``: one undirected edge a stored entry,
    where (i, j) and (j, i) share one weight, the later in CSR order."""
    coo = sp.csr_matrix(W).tocoo()
    n = W.shape[0]
    a = np.zeros((n, n))
    lo = np.minimum(coo.row, coo.col).astype(np.int64)
    hi = np.maximum(coo.row, coo.col).astype(np.int64)
    # the last entry of each pair wins, as add_edge overwrites
    _, last = np.unique((lo * n + hi)[::-1], return_index=True)
    pick = len(lo) - 1 - last
    a[lo[pick], hi[pick]] = coo.data[pick]
    a[hi[pick], lo[pick]] = coo.data[pick]
    return a


def _fruchterman_reingold(A: np.ndarray, pos: np.ndarray,
                          iterations: int = 50,
                          threshold: float = 1e-4) -> np.ndarray:
    """networkx's dense ``_fruchterman_reingold`` (no fixed nodes)."""
    nnodes = A.shape[0]
    k = np.sqrt(1.0 / nnodes)
    t = max(max(pos.T[0]) - min(pos.T[0]), max(pos.T[1]) - min(pos.T[1])) \
        * 0.1
    dt = t / (iterations + 1)
    for _ in range(iterations):
        delta = pos[:, np.newaxis, :] - pos[np.newaxis, :, :]
        distance = np.linalg.norm(delta, axis=-1)
        np.clip(distance, 0.01, None, out=distance)
        displacement = np.einsum(
            "ijk,ij->ik", delta, (k * k / distance**2 - A * distance / k))
        length = np.linalg.norm(displacement, axis=-1)
        length = np.clip(length, a_min=0.01, a_max=None)
        delta_pos = np.einsum("ij,i->ij", displacement, t / length)
        pos += delta_pos
        t -= dt
        if (np.linalg.norm(delta_pos) / nnodes) < threshold:
            break
    return pos


def _energy_fruchterman_reingold(A, pos: np.ndarray, iterations: int = 50,
                                 threshold: float = 1e-4,
                                 gravity: float = 1.0) -> np.ndarray:
    """networkx's ``_energy_fruchterman_reingold`` (no fixed nodes) on the
    float32 CSR adjacency ``A``."""
    import scipy.optimize
    import scipy.sparse.csgraph
    nnodes, dim = pos.shape
    k = np.sqrt(1.0 / nnodes)
    A = np.abs(A)
    A = (A + A.T) / 2
    n_components, labels = scipy.sparse.csgraph.connected_components(
        A, directed=False)
    bincount = np.bincount(labels)
    batchsize = 500

    def cost_fr(x):
        pos = x.reshape((nnodes, dim))
        grad = np.zeros((nnodes, dim))
        cost = 0.0
        for lo in range(0, nnodes, batchsize):
            hi = min(lo + batchsize, nnodes)
            delta = pos[lo:hi, np.newaxis, :] - pos[np.newaxis, :, :]
            distance2 = np.sum(delta * delta, axis=2)
            distance2 = np.maximum(distance2, 1e-10)
            distance = np.sqrt(distance2)
            ad = A[lo:hi] * distance
            grad[lo:hi] = 2 * np.einsum("ij,ijk->ik",
                                        ad / k - k**2 / distance2, delta)
            cost += np.sum(ad * distance2) / (3 * k)
            cost -= k**2 * np.sum(np.log(distance))
        centers = np.zeros((n_components, dim))
        np.add.at(centers, labels, pos)
        delta0 = centers / bincount[:, np.newaxis] - 0.5
        grad += gravity * delta0[labels]
        cost += gravity * 0.5 * np.sum(
            bincount * np.linalg.norm(delta0, axis=1) ** 2)
        return cost, grad.ravel()

    options = {"maxiter": iterations, "gtol": threshold}
    return scipy.optimize.minimize(
        cost_fr, pos.ravel(), method="L-BFGS-B", jac=True,
        options=options).x.reshape((nnodes, dim))


def spring_layout(W: sp.spmatrix) -> np.ndarray:
    """(N, 2) coordinates: networkx's ``spring_layout(
    from_scipy_sparse_array(W), seed=0)`` as an array in node order."""
    n = W.shape[0]
    if n == 0:
        return np.zeros((0, 2))
    if n == 1:
        return np.zeros((1, 2))
    a = _adjacency(W)
    rand = np.random.RandomState(0)
    if n >= 500:
        af = sp.csr_array(a.astype(np.float32))
        pos = np.asarray(rand.rand(n, 2), dtype=af.dtype)
        pos = _energy_fruchterman_reingold(af, pos)
    else:
        pos = np.asarray(rand.rand(n, 2), dtype=a.dtype)
        pos = _fruchterman_reingold(a, pos)
    pos -= pos.mean(axis=0)
    lim = np.abs(pos).max()
    if lim > 0:
        pos *= 1 / lim
    return pos


def plot_coarsening(W: sp.spmatrix, level_parents: List[np.ndarray],
                    coords: Optional[np.ndarray] = None,
                    path: Optional[str] = None, max_nodes: int = 2000):
    """One subplot per level; nodes coloured by the group they contract
    into.

    ``coords``: (N, 2) layout for the finest level (``spring_layout`` when
    absent).  Returns the matplotlib figure (also saved to ``path``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    W = sp.csr_matrix(W)
    n = W.shape[0]
    if n > max_nodes:
        raise ValueError(f"visualizer is for small graphs (≤{max_nodes})")
    if coords is None:
        coords = spring_layout(W)

    levels = len(level_parents)
    fig, axes = plt.subplots(1, levels + 1, figsize=(4 * (levels + 1), 4))
    if levels == 0:
        axes = [axes]

    cur_W = W
    cur_coords = coords
    for lvl in range(levels + 1):
        ax = axes[lvl]
        coo = sp.triu(cur_W, k=1).tocoo()
        for i, j in zip(coo.row, coo.col):
            ax.plot([cur_coords[i, 0], cur_coords[j, 0]],
                    [cur_coords[i, 1], cur_coords[j, 1]],
                    color="0.8", lw=0.5, zorder=1)
        if lvl < levels:
            parent = level_parents[lvl]
            colors = parent % 20
            ax.scatter(cur_coords[:, 0], cur_coords[:, 1], c=colors,
                       cmap="tab20", s=18, zorder=2)
            # contract for the next level: coords = group means
            k = int(parent.max()) + 1
            nxt = np.zeros((k, 2))
            cnt = np.bincount(parent, minlength=k).astype(float)
            for d in range(2):
                np.add.at(nxt[:, d], parent, cur_coords[:, d])
            nxt /= cnt[:, None]
            M = sp.csr_matrix(
                (np.ones(len(parent)), (np.arange(len(parent)), parent)),
                shape=(len(parent), k))
            cur_W = sp.csr_matrix(M.T @ cur_W @ M)
            cur_W.setdiag(0)
            cur_W.eliminate_zeros()
            cur_coords = nxt
        else:
            ax.scatter(cur_coords[:, 0], cur_coords[:, 1], c="k", s=18,
                       zorder=2)
        nodes = cur_W.shape[0] if lvl == levels else len(cur_coords)
        ax.set_title(f"level {lvl}: {nodes} nodes")
        ax.axis("off")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig
