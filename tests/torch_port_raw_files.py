"""Small raw dataset files in each format the loaders read, written from
a seed (``tests/test_torch_port_loaders.py``, ``test_torch_port_cli.py``).
Each writer puts its files under ``<root>/<name>/raw`` (OGB's splits under
``<root>/<name>/split``) and returns nothing; the tests hold the port's
loaders against the JAX package's on them."""

import gzip
import json
import os
import pickle

import numpy as np
import scipy.sparse as sp
import torch


def _raw(root, name):
    raw = os.path.join(root, name, "raw")
    os.makedirs(raw, exist_ok=True)
    return raw


def write_planetoid(root, name="cora", n_train=7, n_val=9, n_test=6, f=10,
                    c=3, gaps=False, seed=0):
    """``ind.<name>.*`` pickles (scipy CSR features, one-hot labels, an
    adjacency dict).  ``gaps``: the test ids skip some of their range,
    as citeseer's do, so tx holds fewer rows than the range."""
    raw = _raw(root, name)
    rng = np.random.default_rng(seed)
    n_allx = n_train + n_val
    span = n_test + (3 if gaps else 0)
    ids = np.arange(n_allx, n_allx + span)
    if gaps:
        ids = np.sort(rng.choice(ids[1:-1], n_test - 2, replace=False))
        ids = np.concatenate([[n_allx], ids, [n_allx + span - 1]])
    n = n_allx + span

    def onehot(k):
        return np.eye(c)[rng.integers(0, c, size=k)]

    def feats(k):
        a = rng.random((k, f)).astype(np.float32)
        a[a < 0.6] = 0.0
        return sp.csr_matrix(a)

    objs = dict(x=feats(n_train), y=onehot(n_train), tx=feats(n_test),
                ty=onehot(n_test), allx=feats(n_allx), ally=onehot(n_allx),
                graph={i: [int(j) for j in rng.integers(0, n + 2, 3)]
                       for i in range(n)})
    for key, obj in objs.items():
        with open(os.path.join(raw, f"ind.{name}.{key}"), "wb") as fo:
            pickle.dump(obj, fo)
    with open(os.path.join(raw, f"ind.{name}.test.index"), "w") as fo:
        fo.write("\n".join(str(i) for i in rng.permutation(ids)))


def write_wikipedia(root, name="chameleon", n=9, f=4, seed=1):
    raw = _raw(root, name)
    rng = np.random.default_rng(seed)
    lines = ["node_id\tfeature\tlabel"]
    for i in range(n):
        feat = ",".join(str(int(v)) for v in rng.integers(0, 2, f))
        lines.append(f"{i}\t{feat}\t{int(rng.integers(1, 5000))}")
    with open(os.path.join(raw, "out1_node_feature_label.txt"), "w") as fo:
        fo.write("\n".join(lines) + "\n")
    e = rng.integers(0, n, (14, 2))
    with open(os.path.join(raw, "out1_graph_edges.txt"), "w") as fo:
        fo.write("id1\tid2\n" + "".join(f"{a}\t{b}\n" for a, b in e))


def write_tu(root, name="PROTEINS", features="labels", seed=2):
    """Three graphs (sizes 4, 3, 5) with 1-based ids, edges listed out of
    graph order; ``features``: "attributes", "labels" or "none"."""
    raw = _raw(root, name)
    rng = np.random.default_rng(seed)
    sizes = [4, 3, 5]
    gi = np.repeat(np.arange(len(sizes)), sizes)
    off = np.concatenate([[0], np.cumsum(sizes)])
    edges = []
    for g, k in enumerate(sizes):
        for _ in range(2 * k):
            a, b = rng.integers(0, k, 2) + off[g]
            edges.append((a, b))
    edges = [edges[i] for i in rng.permutation(len(edges))]
    pre = os.path.join(raw, name)
    with open(f"{pre}_A.txt", "w") as fo:
        fo.write("".join(f"{a + 1}, {b + 1}\n" for a, b in edges))
    with open(f"{pre}_graph_indicator.txt", "w") as fo:
        fo.write("".join(f"{g + 1}\n" for g in gi))
    with open(f"{pre}_graph_labels.txt", "w") as fo:
        fo.write("".join(f"{v}\n" for v in (2, 1, 2)))
    if features == "attributes":
        a = rng.standard_normal((len(gi), 3))
        with open(f"{pre}_node_attributes.txt", "w") as fo:
            fo.write("".join(", ".join(f"{v:.6f}" for v in row) + "\n"
                             for row in a))
    elif features == "labels":
        with open(f"{pre}_node_labels.txt", "w") as fo:
            fo.write("".join(f"{v}\n" for v in rng.integers(1, 4,
                                                             len(gi))))


def write_wikics(root, n=8, f=5, seed=3):
    raw = _raw(root, "wikics")
    rng = np.random.default_rng(seed)
    d = {"features": rng.standard_normal((n, f)).round(4).tolist(),
         "labels": rng.integers(0, 3, n).tolist(),
         "links": [sorted(set(rng.integers(0, n, 2).tolist()))
                   for _ in range(n)],
         "train_masks": (rng.random((3, n)) < 0.5).tolist(),
         "val_masks": (rng.random((3, n)) < 0.3).tolist(),
         "test_mask": (rng.random(n) < 0.4).tolist()}
    with open(os.path.join(raw, "data.json"), "w") as fo:
        json.dump(d, fo)


def write_attributed_npz(root, name="physics", dense=False, file=None,
                         n=7, f=6, seed=4):
    """The GNN-benchmark npz: CSR adjacency, CSR (or ``dense``)
    attributes, labels; ``file`` names it otherwise than ``<name>.npz``."""
    raw = _raw(root, name)
    rng = np.random.default_rng(seed)
    adj = sp.csr_matrix((rng.random((n, n)) < 0.3).astype(np.float32))
    attr = rng.random((n, f)).astype(np.float32)
    attr[attr < 0.5] = 0.0
    arrays = dict(adj_data=adj.data, adj_indices=adj.indices,
                  adj_indptr=adj.indptr, adj_shape=adj.shape,
                  labels=rng.integers(0, 4, n))
    if dense:
        arrays["attr_matrix"] = attr
    else:
        a = sp.csr_matrix(attr)
        arrays.update(attr_data=a.data, attr_indices=a.indices,
                      attr_indptr=a.indptr, attr_shape=a.shape)
    np.savez(os.path.join(raw, file or f"{name}.npz"), **arrays)


def write_graphsaint(root, name="flickr", multilabel=False, n=6, f=3,
                     seed=5):
    raw = _raw(root, name)
    rng = np.random.default_rng(seed)
    sp.save_npz(os.path.join(raw, "adj_full.npz"), sp.csr_matrix(
        (rng.random((n, n)) < 0.4).astype(np.float64)))
    np.save(os.path.join(raw, "feats.npy"), rng.standard_normal((n, f)))
    cmap = {str(i): (rng.integers(0, 2, 3).tolist() if multilabel
                     else int(rng.integers(0, 4))) for i in range(n)}
    with open(os.path.join(raw, "class_map.json"), "w") as fo:
        json.dump(cmap, fo)
    with open(os.path.join(raw, "role.json"), "w") as fo:
        json.dump({"tr": [0, 2], "va": [1], "te": [3, 5]}, fo)


def _sdf_block(rng, na, bad=None):
    atoms = "HCNOF"
    lines = ["gdb", "     RDKit          3D", "",
             f"{na:3d}{na - 1:3d}  0  0  0  0  0  0  0  0999 V2000"
             if bad != "counts" else "  x  y  0  0  0  0999 V2000"]
    for i in range(na):
        xyz = rng.standard_normal(3)
        sym = atoms[int(rng.integers(0, 5))]
        coord = "   abc" if (bad == "atom" and i == 1) else f"{xyz[0]:10.4f}"
        lines.append(f"{coord}{xyz[1]:10.4f}{xyz[2]:10.4f} {sym}   0  0")
    for i in range(1, na):
        lines.append(f"{int(rng.integers(0, i)) + 1:3d}{i + 1:3d}  1  0")
    lines.append("M  END")
    return "\n".join(lines) + "\n"


def write_qm9(root, seed=6):
    """Five sdf blocks, the second with an unreadable atom line and the
    fourth with an unreadable counts line (both skipped with their target
    rows), and six csv rows (one more than blocks)."""
    raw = _raw(root, "QM9")
    rng = np.random.default_rng(seed)
    bad = {1: "atom", 3: "counts"}
    blocks = [_sdf_block(rng, int(rng.integers(3, 7)), bad.get(i))
              for i in range(5)]
    with open(os.path.join(raw, "gdb9.sdf"), "w") as fo:
        fo.write("$$$$\n".join(blocks) + "$$$$\n")
    header = "mol_id," + ",".join(f"p{i}" for i in range(19))
    rows = [f"gdb_{i}," + ",".join(f"{v:.5f}" for v in
                                   rng.standard_normal(19))
            for i in range(6)]
    with open(os.path.join(raw, "gdb9.sdf.csv"), "w") as fo:
        fo.write(header + "\n" + "\n".join(rows) + "\n")


def _gz(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as fo:
        fo.write("".join(",".join(map(str, r)) + "\n" for r in rows))


def float_texts(rng, n):
    """Float fields written as a user's files carry them: full repr,
    fixed, exponent, integral, negative zero."""
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 5, n)
    forms = (repr, lambda a: f"{a:.6f}", lambda a: f"{a:.3e}",
             lambda a: f"{a:.9g}", lambda a: str(int(a)),
             lambda a: f"{float(np.float32(a))!r}")
    out = [forms[i % len(forms)](float(a)) for i, a in enumerate(v)]
    out[0] = "-0.0"
    return out


def write_ogbn(root, name="ogbn-arxiv", mode="feat", n=12, f=5, seed=7):
    """OGB's layout; ``mode``: "feat" (node-feat.csv.gz, labels, two
    split directories: the first, sorted, is read), "edge_feat" (proteins:
    no node features, multi-task labels, edge features), "species"
    (no node or edge features, node_species.csv.gz, no labels)."""
    base = os.path.join(root, name)
    raw = _raw(root, name)
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, (20, 2))
    e[0] = (n - 1, 0)
    _gz(os.path.join(raw, "edge.csv.gz"), e.tolist())
    if mode == "feat":
        vals = np.array(float_texts(rng, n * f)).reshape(n, f)
        _gz(os.path.join(raw, "node-feat.csv.gz"), vals.tolist())
        _gz(os.path.join(raw, "node-label.csv.gz"),
            rng.integers(0, 4, (n, 1)).tolist())
        for sub, lo in (("time", 0), ("z_other", 6)):
            perm = np.roll(np.arange(n), lo)
            for part, sl in (("train", slice(0, 6)), ("valid", slice(6, 9)),
                             ("test", slice(9, n))):
                _gz(os.path.join(base, "split", sub, f"{part}.csv.gz"),
                    perm[sl][:, None].tolist())
    elif mode == "edge_feat":
        ef = np.array(float_texts(rng, 20 * 3)).reshape(20, 3)
        _gz(os.path.join(raw, "edge-feat.csv.gz"), ef.tolist())
        _gz(os.path.join(raw, "node-label.csv.gz"),
            rng.integers(0, 2, (n, 2)).tolist())
    else:
        _gz(os.path.join(raw, "node_species.csv.gz"),
            rng.choice([9606, 3702, 10090], (n, 1)).tolist())


def write_zinc(root, big=4003, seed=8):
    """benchmarking-gnns pickles: ``big`` molecules in train (more than
    the subset's 4,000), a few in val and test; dense bond matrices on
    even molecules, an ``edge_list`` on odd ones; torch tensors."""
    raw = _raw(root, "ZINC")
    rng = np.random.default_rng(seed)

    def mol(i):
        n = int(rng.integers(2, 6))
        d = {"atom_type": torch.from_numpy(rng.integers(0, 30, n)),
             "logP_SA_cycle_normalized": torch.tensor(
                 [float(rng.standard_normal())])}
        pairs = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
        if i % 2 == 0:
            bond = np.zeros((n, n), dtype=np.int64)
            bond[pairs[:, 0], pairs[:, 1]] = rng.integers(1, 4, n - 1)
            bond[pairs[:, 1], pairs[:, 0]] = bond[pairs[:, 0], pairs[:, 1]]
            d["bond_type"] = torch.from_numpy(bond)
        else:
            d["bond_type"] = torch.from_numpy(rng.integers(1, 4, n - 1))
            d["edge_list"] = torch.from_numpy(pairs)
        return d

    for part, k in (("train", big), ("val", 5), ("test", 4)):
        with open(os.path.join(raw, f"{part}.pickle"), "wb") as fo:
            pickle.dump([mol(i) for i in range(k)], fo)
