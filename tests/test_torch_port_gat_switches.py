"""GAT's four diagnostic switches against the JAX package, on the CPU.

``FITGNN_GAT_FUSED_BWD``, ``FITGNN_GAT_FUSED_SORTED_DH``,
``FITGNN_GAT_SORTED_SRC`` and ``FITGNN_GAT_SORTED_NUM`` select straggler
branches of ``tile_gat_attention`` whose backward the JAX package writes
as ``custom_vjp``s and the port as ``torch.autograd.Function``s.  The JAX
package reads its switches once, when it is imported, so the tests set its
module globals (``monkeypatch.setattr``) and the environment variables the
port reads at each call.  On seeded operators (the default grid-walk tiles
at edge 128, the diagonal opt-in at 256 on bf16 masks, the cluster
collapse) the port's output and gradients (in ``h``, ``att_src`` through
``score_src``, and ``score_dst``) are held against the JAX package's, and
the branch each switch setting takes is held against the JAX package's
predicates.  The JAX Pallas kernels run in interpret mode; the port's
wrappers take their plain versions because the tensors lie on the CPU.

Tolerances (``tests/test_torch_port_gat.py``'s): values within rtol 1e-4
and atol 1e-5·max(1, max|ref|), gradients within rtol 1e-4 and atol
1e-4·max(1, max|ref|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitgnn_tpu.ops import tile_gat as jax_tile_gat_mod
from fitgnn_tpu.ops.hybrid_spmm import build_hybrid as jax_build_hybrid

from fitgnn_tpu_torch.ops import tile_gat
from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
from fitgnn_tpu_torch.ops.tile_gat import switches, tile_gat_attention

torch.set_num_threads(1)

SLOPE = 0.2
N = 512

# the port's environment variable and the JAX package's module global of
# each switch
SWITCH = {"FUSED_BWD": ("FITGNN_GAT_FUSED_BWD", "_FUSED_BWD"),
          "SORTED_DH": ("FITGNN_GAT_FUSED_SORTED_DH",
                        "_FUSED_BWD_SORTED_DH"),
          "SORTED_SRC": ("FITGNN_GAT_SORTED_SRC", "_SORTED_SRC"),
          "SORTED_NUM": ("FITGNN_GAT_SORTED_NUM", "_SORTED_NUM"),
          "EXACT": ("FITGNN_GAT_GLOBAL_MAX", "_GLOBAL_MAX"),
          "SEGMM_DEN": ("FITGNN_GAT_SEGMM_DEN", "_SEGMM_DEN"),
          "FUSED_TILES": ("FITGNN_GAT_FUSED_TILES", "_FUSED_TILES")}


def close(got, ref, grad=False):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=(1e-4 if grad else 1e-5) * scale)


def set_switches(monkeypatch, on):
    """Both packages' switches: those in ``on`` set, the others at their
    defaults (``EXACT`` turns the global max off)."""
    for name, (env, glob) in SWITCH.items():
        value = name in on
        if name == "EXACT":
            monkeypatch.setenv(env, "0" if value else "1")
            monkeypatch.setattr(jax_tile_gat_mod, glob, not value)
        else:
            monkeypatch.setenv(env, "1" if value else "0")
            monkeypatch.setattr(jax_tile_gat_mod, glob, value)


def community_coo(seed, block=128, nblocks=4, deg=10):
    """Receiver-sorted COO on ``block``-node communities: 65% of the edges
    inside the community (dense diagonal tiles), 15% from the next one
    into an even one (dense off-diagonal tiles), 20% anywhere (stragglers
    at a threshold of ``block`` edges a tile); about 2% of the edges carry
    weight 0 (padding-like)."""
    rng = np.random.default_rng(seed)
    n = block * nblocks
    e = n * deg
    r = np.sort(rng.integers(0, n, e))
    u = rng.random(e)
    own = r // block
    blk = np.where((u < 0.65) | (own % 2 == 1), own, (own + 1) % nblocks)
    s = np.where(u < 0.8, blk * block + rng.integers(0, block, e),
                 rng.integers(0, n, e))
    w = (rng.random(e) > 0.02).astype(np.float32)
    return s, r, w, n


# the operators: (edge, build_hybrid's arguments beside att_unit, bf16)
OPS = {"default": (128, dict(use_segmm=False), False),
       "segmm": (128, dict(use_segmm=True), False),
       "diag256bf": (256, dict(use_segmm=False, use_diag=True), True),
       "cluster": (128, dict(use_segmm=False, cluster_att=128,
                             cluster_att_exact=16), False)}


def operators(case):
    block, kw, bf16 = OPS[case]
    s, r, w, n = community_coo(4, block=block)
    args = dict(min_block_edges=block, block=block,
                semantics="att_unit", **kw)
    ht = build_hybrid(s, r, w, n, tile_dtype=torch.bfloat16 if bf16
                      else None, **args)
    hj = jax_build_hybrid(s, r, w, n, tile_dtype=jnp.bfloat16 if bf16
                          else None, **args)
    assert ht.bsr is not None and ht.num_coo_edges > 50
    return ht, hj, n


def attention_vs_jax(ht, hj, n, feat, with_att_src=True, seed=31):
    """``tile_gat_attention`` in both packages on seeded ``h``, ``att_src``
    and ``score_dst`` (``score_src = h @ att_src``); without
    ``with_att_src`` the function is not handed ``att_src`` (the sender
    scores are then gathered from ``score_src``)."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, feat)).astype(np.float32)
    a = (rng.standard_normal(feat) / np.sqrt(feat)).astype(np.float32)
    sd = rng.standard_normal(n).astype(np.float32)
    tgt = rng.standard_normal((n, feat)).astype(np.float32)

    def loss_j(hh, aa, ss):
        out = jax_tile_gat_mod.tile_gat_attention(
            hj, hh @ aa, ss, hh, SLOPE,
            att_src=aa if with_att_src else None)
        return jnp.sum((out - tgt) ** 2), out

    # jitted: the switches are read when it traces, here
    (_, out_j), grads_j = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(h), jnp.asarray(a), jnp.asarray(sd))
    hh, at, st = (torch.tensor(v, requires_grad=True) for v in (h, a, sd))
    out = tile_gat_attention(ht, hh @ at, st, hh, SLOPE,
                             att_src=at if with_att_src else None)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    assert torch.isfinite(out).all()
    close(out, out_j)
    for got, ref in zip((hh.grad, at.grad, st.grad), grads_j):
        assert torch.isfinite(got).all()
        close(got, ref, grad=True)


# (switches on, operator, feature width, att_src handed over)
CASES = [(("FUSED_BWD",), "default", 16, True),
         (("FUSED_BWD", "SORTED_DH"), "default", 16, True),
         (("SORTED_NUM",), "default", 16, True),
         (("SORTED_SRC",), "default", 16, False),
         (("SORTED_NUM", "SORTED_SRC"), "default", 16, True),
         (("FUSED_BWD",), "diag256bf", 16, True),
         (("FUSED_BWD", "SORTED_DH"), "cluster", 16, True),
         (("SORTED_NUM", "SORTED_SRC", "EXACT"), "cluster", 16, True),
         (("FUSED_BWD", "SORTED_DH"), "segmm", 80, True)]


@pytest.mark.parametrize(
    "on,case,feat,with_att_src", CASES,
    ids=["+".join(c[0]) + f"-{c[1]}" + ("" if c[3] else "-no_att_src")
         for c in CASES])
def test_switches_match_jax(monkeypatch, on, case, feat, with_att_src):
    """Each diagnostic setting on its operator: the output and the
    gradients in ``h``, ``att_src`` and ``score_dst`` (``FUSED_BWD`` on
    the K3w operator at F = 80, above ``SEGMM_MAXF``)."""
    set_switches(monkeypatch, on)
    ht, hj, n = operators(case)
    attention_vs_jax(ht, hj, n, feat, with_att_src)


def _branches(monkeypatch, feat=16, att_src=True, case="default"):
    """The straggler primitives one call of the port's
    ``tile_gat_attention`` applies (forward and backward)."""
    used = []
    for name in ("_StragglerAttentionFused", "_WeightedSpmmSorted",
                 "_GatherSenders"):
        fn = getattr(tile_gat, name)

        def apply(*args, _fn=fn, _name=name):
            used.append(_name)
            return _fn.apply(*args)

        monkeypatch.setattr(tile_gat, name, type(name, (), {
            "apply": staticmethod(apply)}))
    ht, _, n = operators(case)
    rng = np.random.default_rng(0)
    h = torch.tensor(rng.standard_normal((n, feat)).astype(np.float32),
                     requires_grad=True)
    a = torch.tensor(rng.standard_normal(feat).astype(np.float32),
                     requires_grad=True)
    sd = torch.tensor(rng.standard_normal(n).astype(np.float32),
                      requires_grad=True)
    tile_gat_attention(ht, h @ a, sd, h, SLOPE,
                       att_src=a if att_src else None).sum().backward()
    return used


# the JAX package's predicates (fitgnn_tpu/ops/tile_gat.py): FUSED_BWD needs
# the global max, att_src, the sorted backward, no K3w or K6 (no segmm at
# F ≤ 64, no SEGMM_DEN), neither SORTED switch and no FUSED_TILES;
# SORTED_NUM (no K3w or K6) takes the numerator; SORTED_SRC gathers the
# sender scores where the gathered rows do not give them
PREDICATES = [
    (("FUSED_BWD",), {}, ["_StragglerAttentionFused"]),
    (("FUSED_BWD", "SORTED_DH"), {}, ["_StragglerAttentionFused"]),
    (("FUSED_BWD", "EXACT"), {}, []),
    (("FUSED_BWD", "FUSED_TILES"), {}, []),
    (("FUSED_BWD", "SORTED_NUM"), {}, ["_WeightedSpmmSorted"]),
    (("FUSED_BWD", "SORTED_SRC"), {}, []),
    (("FUSED_BWD",), dict(att_src=False), []),
    (("FUSED_BWD",), dict(case="segmm"), []),
    (("FUSED_BWD",), dict(case="segmm", feat=80),
     ["_StragglerAttentionFused"]),
    (("FUSED_BWD", "SEGMM_DEN"), dict(case="segmm", feat=80), []),
    (("SORTED_NUM",), {}, ["_WeightedSpmmSorted"]),
    (("SORTED_NUM",), dict(case="segmm"), []),
    (("SORTED_SRC",), {}, []),
    (("SORTED_SRC",), dict(att_src=False), ["_GatherSenders"]),
    (("SORTED_SRC", "SORTED_NUM"), {},
     ["_GatherSenders", "_WeightedSpmmSorted"]),
    (("SORTED_SRC",), dict(case="segmm"), ["_GatherSenders"]),
    (("SORTED_DH",), {}, [])]


@pytest.mark.parametrize(
    "on,kw,want", PREDICATES,
    ids=["+".join(p[0]) + "".join(f"-{k}={v}" for k, v in p[1].items())
         for p in PREDICATES])
def test_branch_selection_follows_jax_predicates(monkeypatch, on, kw, want):
    set_switches(monkeypatch, on)
    assert _branches(monkeypatch, **kw) == want


def test_switches_read_at_call_time(monkeypatch):
    """Each switch is on only at exactly ``"1"``, read at each call."""
    for name, (env, _) in SWITCH.items():
        monkeypatch.delenv(env, raising=False)
    assert switches() == tile_gat.Switches()
    fields = {"FITGNN_GAT_FUSED_BWD": "fused_bwd",
              "FITGNN_GAT_FUSED_SORTED_DH": "fused_sorted_dh",
              "FITGNN_GAT_SORTED_SRC": "sorted_src",
              "FITGNN_GAT_SORTED_NUM": "sorted_num"}
    for env, field in fields.items():
        monkeypatch.setenv(env, "true")
        assert not getattr(switches(), field)
        monkeypatch.setenv(env, "1")
        assert getattr(switches(), field)


@pytest.mark.parametrize("kwargs", [dict(partials=True),
                                    dict(src_score_bound=1.0),
                                    dict(extra_rowmax=np.zeros(N))],
                         ids=["partials", "src_score_bound",
                              "extra_rowmax"])
def test_distributed_arguments_still_raise(monkeypatch, kwargs):
    """Kept under its name from before the distributed layer was ported:
    its three arguments no longer raise.  Each, alone, gives the JAX
    package's result on the default operator under the global max with
    ``FUSED_BWD`` on, a branch that ``partials`` switches off in both
    packages."""
    set_switches(monkeypatch, ("FUSED_BWD",))
    ht, hj, n = operators("default")
    rng = np.random.default_rng(5)
    h = rng.standard_normal((n, 4)).astype(np.float32)
    a = rng.standard_normal(4).astype(np.float32)
    ss, sd = h @ a, rng.standard_normal(n).astype(np.float32)
    tk = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in kwargs.items()}
    jk = {k: jnp.asarray(v) for k, v in kwargs.items()}
    got = tile_gat_attention(ht, torch.from_numpy(ss), torch.from_numpy(sd),
                             torch.from_numpy(h), SLOPE,
                             att_src=torch.from_numpy(a), **tk)
    ref = jax.jit(lambda b, c, d, e: jax_tile_gat_mod.tile_gat_attention(
        hj, b, c, d, SLOPE, att_src=e, **jk))(
            jnp.asarray(ss), jnp.asarray(sd), jnp.asarray(h), jnp.asarray(a))
    if kwargs.get("partials"):
        assert len(got) == len(ref) == 3
    else:
        got, ref = (got,), (ref,)
    for g, r in zip(got, ref):
        close(g, r)
