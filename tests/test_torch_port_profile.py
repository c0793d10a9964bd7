"""The profile scripts' kernel groups, on the CPU.

Every instantiation of the non-zero walk of ``csrc/tile_sparse.cuh``, by the
demangled name a profiler reports for it, must land in the group of the
wrapper that launches it: K7f and K7bt's ``dx`` by their value hooks, never
in K4 or K4ᵀ, whose walks they share; the other walks by their flags.
"""

import importlib.util
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import walk_args  # noqa: E402

torch.set_num_threads(1)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_train = _script("torch_train_profile")
_serve = _script("torch_serve_profile")


def _walk(trans, init, vec, diag, hook):
    flags = ", ".join(str(v).lower() for v in (trans, init, vec, diag))
    return (f"void sparse::walk_kernel<{flags}, {hook}>(float const*, int "
            "const*, int const*, int const*, int const*, float const*, "
            f"float const*, float*, long, long, {hook})")


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("trans,init,diag,hook", [
    (False, False, False, "att::FwdScores"),
    (True, False, False, "att::DxScores"),
    (False, True, False, "sparse::Plain"),
    (True, True, True, "sparse::Plain")])
def test_walk_args_reads_flags_and_hook(trans, init, diag, hook, vec):
    assert walk_args(_walk(trans, init, vec, diag, hook)) == (
        trans, init, diag, hook.split("::")[-1])


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::att_scores_kernel<true>(float const*)",
    "void (anonymous namespace)::att_sums_kernel(float const*)"])
def test_walk_args_ignores_other_kernels(name):
    assert walk_args(name) is None


@pytest.mark.parametrize("name,rows_walk,group", [
    (_walk(False, False, True, False, "att::FwdScores"), None, "K7f att_fwd"),
    (_walk(False, False, False, False, "att::FwdScores"), None,
     "K7f att_fwd"),
    (_walk(True, False, True, False, "att::DxScores"), None,
     "K7bt att_bwd_t (dx)"),
    (_walk(False, False, True, False, "sparse::Plain"), "K4 dyn_tiles",
     "K4 dyn_tiles"),
    (_walk(True, False, True, False, "sparse::Plain"), "K4 dyn_tiles",
     "K4T dyn_tiles_t"),
    (_walk(False, True, True, False, "sparse::Plain"), _train.K1,
     _train.K1),
    (_walk(True, True, False, True, "sparse::Plain"), _train.K1,
     "K8 diag_spmm"),
    ("void (anonymous namespace)::att_scores_kernel<true>(float const*)",
     None, _train.K7S),
    ("void (anonymous namespace)::att_scores_kernel<false>(float const*)",
     None, _train.K7S),
    ("void (anonymous namespace)::att_sums_kernel(float const*, float "
     "const*, int const*, int const*, int const*, int const*, float*, "
     "float*, long)", None, _train.K7SUMS),
    ("void (anonymous namespace)::att_rowmax_kernel(float const*)", None,
     "K7rm att_rowmax")] + [
    # the straggler sum, segmm_spmm_kernel<DEN, L, VEC>: K6 with den
    (f"void (anonymous namespace)::segmm_spmm_kernel<{den}, {lanes}, {vec}>"
     "(int const*, int const*, float const*, float const*, int const*, "
     "float const*, float*, float*, long, long, int, int)", None,
     "K6 segmm_weighted_den_raw" if den == "true" else "K3/K3w segmm_spmm")
    for den in ("true", "false") for lanes in (8, 16, 32)
    for vec in ("true", "false")])
def test_train_profile_groups(name, rows_walk, group):
    assert _train._group(name, rows_walk) == group


def test_train_profile_refuses_an_unexpected_rows_walk():
    with pytest.raises(RuntimeError, match="no rows walk from zero"):
        _train._group(_walk(False, False, True, False, "sparse::Plain"),
                      None)


def test_serve_profile_groups():
    assert _serve._group(_walk(False, True, True, False, "sparse::Plain")) \
        == "K1 bsr_spmm_acc"
    with pytest.raises(RuntimeError, match="no walk but K1's"):
        _serve._group(_walk(False, False, True, False, "att::FwdScores"))
