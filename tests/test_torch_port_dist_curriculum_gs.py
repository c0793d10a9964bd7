"""The port's subgraph-axis Gs steps (``parallel/dist_subgraphs.py``)
against the JAX package's on 4 shards, on the CPU.

The JAX side runs in this process on 4 of the host devices that
``conftest.py`` forces (``make_dist_gs_train_step_multi``,
``make_dist_gs_train_epoch_mb``, ``make_dist_gs_eval_step_multi``); the
port's in one gloo world of 4 ranks (``torch_port_dist_worker.py``),
started first, each rank on its slice of the same padded batches.  From
the JAX package's initial parameters at dropout 0, on one batch and on
size buckets: the val and test (loss, metric) for classification and
regression, one GD step's loss and parameters, and one MB epoch's loss,
parameters and Adam step count with global chunk 1 cleared of train nodes
on every rank (so every rank skips it).  ``pad_batch_to_shards`` is held
exactly.  Tolerance: rtol 1e-4, atol 1e-4·max|ref|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.parallel import make_mesh
from fitgnn_tpu.parallel.dist_subgraphs import (
    make_dist_gs_eval_step_multi, make_dist_gs_train_epoch_mb,
    make_dist_gs_train_step_multi, pad_batch_to_shards as jax_pad)

from fitgnn_tpu_torch.parallel import pad_batch_to_shards

from torch_port_dist_curriculum_cases import (HIDDEN, LR, WD,
                                              assert_params_close,
                                              batches_of, close, jax_params,
                                              out_dim, partitions,
                                              port_params)
from torch_port_dist_worker import World

torch.set_num_threads(1)

P = 4
MB_BATCH = 32          # 8 subgraphs a rank's chunk
SKIPPED = 1            # the global chunk without a train node

# (name, task, buckets, method)
CASES = [("gd_one", "classification", False, "GD"),
         ("gd_buckets", "classification", True, "GD"),
         ("mb_one", "classification", False, "MB"),
         ("mb_buckets", "classification", True, "MB"),
         ("gd_reg", "regression", True, "GD")]


def _clear_chunk(b, numpy):
    """``b`` (padded to P shards) with the train nodes of local chunk
    ``SKIPPED`` of every shard cleared."""
    n, bl = b.num_subgraphs // P, MB_BATCH // P
    keep = np.ones(b.num_subgraphs, dtype=bool)
    for d in range(P):
        keep[d * n + SKIPPED * bl:d * n + (SKIPPED + 1) * bl] = False
    tm = np.asarray(b.train_mask) & keep[:, None]
    return b._replace(train_mask=jnp.asarray(tm) if numpy
                      else torch.from_numpy(tm))


def padded(name, task, bucket, method):
    """(the port's batches, the JAX package's), padded to P shards; for MB
    the first bucket's chunk ``SKIPPED`` cleared on both sides."""
    part, jpart = partitions(task, bucket)
    got = [pad_batch_to_shards(b, P) for b in batches_of(part)]
    ref = [jax_pad(b, P) for b in batches_of(jpart)]
    if method == "MB":
        got[0], ref[0] = _clear_chunk(got[0], False), _clear_chunk(ref[0],
                                                                   True)
    return tuple(got), tuple(ref)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = []
    for name, task, bucket, method in CASES:
        got, _ = padded(name, task, bucket, method)
        cases.append((name, dict(
            kind="gs", task=task, layer="GCNConv", method=method,
            batch_size=MB_BATCH, batches=got,
            in_dim=got[0].x.shape[-1], hidden=HIDDEN,
            out_dim=out_dim(task), lr=LR, wd=WD,
            params=port_params(jax_params("GCNConv", task).params))))
    w = World(cases, tmp_path_factory.mktemp("dist_gs"))
    yield w
    w.wait()


@pytest.mark.parametrize("bucket", [False, True], ids=["one", "buckets"])
def test_pad_batch_to_shards_matches_jax(bucket):
    part, jpart = partitions("classification", bucket)
    for b, jb in zip(batches_of(part), batches_of(jpart)):
        got, ref = pad_batch_to_shards(b, P), jax_pad(jb, P)
        assert got.num_subgraphs == ref.num_subgraphs
        assert got.num_subgraphs % P == 0
        for field, g, r in zip(got._fields, got, ref):
            assert (g is None) == (r is None), field
            if g is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                              err_msg=field)
    b = batches_of(part)[0]
    assert pad_batch_to_shards(b, b.num_subgraphs) is b


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dist_gs_steps_match_jax(world, case):
    name, task, bucket, method = case
    _, ref = padded(*case)
    state = jax_params("GCNConv", task)
    mesh = make_mesh(P)
    evals = {s: make_dist_gs_eval_step_multi(mesh, ref, task, split=s)
             for s in ("val", "test")}
    if method == "GD":
        step = make_dist_gs_train_step_multi(mesh, ref, task)
    else:
        step = make_dist_gs_train_epoch_mb(mesh, ref, task,
                                           batch_size=MB_BATCH)
    with mesh:
        ev = {s: [float(v) for v in f(state, ref)] for s, f in evals.items()}
        new, loss = step(state, ref, jax.random.PRNGKey(1))
    if method == "MB":
        # every chunk of every bucket stepped but the cleared one
        n_chunks = sum(-(-(b.num_subgraphs // P) // (MB_BATCH // P))
                       for b in ref)
        assert int(new.step) == n_chunks - 1
    for r in world.results(name):           # every rank holds the result
        for s in ("val", "test"):
            close(r["evals"][s], ev[s], f"{name} {s} eval")
        close(r["loss"], float(loss), f"{name} loss")
        assert_params_close(r["params"], new.params, name)
        assert r["steps"] == int(new.step)
