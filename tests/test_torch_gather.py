"""The constant-table gather pair of ``nn/gather.py`` on the CPU (its plain
CSR reduction), in float64: ``gather_last`` / ``gather_last_t`` against
``torch.index_select``'s autograd, first and second order; a table that
leaves positions out, and that such a table is no adjoint pair;
``tp.apply_dtp_cm``'s gradients against its former ``index_select`` form
on real programs in both input layouts, and on every program the shipped
models build; and bit-equal repeated backward passes.  The CUDA kernel's
cases are in ``tests/test_torch_cuda.py``."""
import glob
import os

import numpy as np
import pytest
import torch

from diffusion_edf_tpu_torch.geom.irreps import Irreps
from diffusion_edf_tpu_torch.nn import tp as ttp
from diffusion_edf_tpu_torch.nn.gather import csr, gather_last, gather_last_t, gather_table

SH = "1x0e+1x1e+1x2e"
PROGRAMS = {  # the tests' tiny width and the shipped pick models' width
    "tiny": ("8x0e+4x1e+2x2e", SH, "8x0e+4x1e+2x2e"),
    "pick": ("64x0e+32x1e+16x2e", SH, "64x0e+32x1e+16x2e"),
}


def _index(kind: str):
    """``(idx, width)``: every column read by a few positions, or one column
    (like apply_dtp_cm's zero column) read by most of them."""
    rng = np.random.default_rng(0)
    if kind == "uniform":
        return rng.integers(0, 7, size=23), 7
    idx = np.full(40, 2)
    idx[rng.choice(40, size=10, replace=False)] = rng.integers(0, 6, size=10)
    return idx, 6


def _table(kind: str, keep=None):
    idx, width = _index(kind)
    return gather_table(("test_gather", kind, None if keep is None else keep.tobytes()), lambda: idx, width, torch.zeros((), dtype=torch.float64),
                        None if keep is None else (lambda: keep))


def _rand(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)


def test_csr_groups_positions_by_column():
    idx = np.array([3, 0, 3, 1, 0, 3])
    ptr, lanes = csr(idx, 5)
    assert ptr.tolist() == [0, 2, 3, 3, 6, 6]
    assert lanes.tolist() == [1, 4, 3, 0, 2, 5]
    ptr, lanes = csr(idx, 5, keep=idx != 3)
    assert ptr.tolist() == [0, 2, 3, 3, 3, 3] and lanes.tolist() == [1, 4, 3]
    assert not _table("uniform").partial and _table("skewed", np.ones(40, dtype=bool)).partial


@pytest.mark.parametrize("kind", ["uniform", "skewed"])
@pytest.mark.parametrize("check", ["first_order", "gradcheck", "gradgradcheck"])
def test_gather_pair_matches_index_select(check, kind):
    table = _table(kind)
    if check == "first_order":
        x = _rand(3, 2, table.width).requires_grad_()
        g = _rand(3, 2, table.idx.shape[0], seed=1)
        y = gather_last(x, table)
        ref_x = x.detach().clone().requires_grad_()
        ref = torch.index_select(ref_x, -1, table.idx)
        assert torch.equal(y, ref)  # the forward is index_select itself
        (gx,) = torch.autograd.grad(y, x, g)
        (ref_gx,) = torch.autograd.grad(ref, ref_x, g)
        torch.testing.assert_close(gx, ref_gx, rtol=0, atol=1e-12)
        # the transpose's own gradient is the gather
        gt = g.clone().requires_grad_()
        (gg,) = torch.autograd.grad(gather_last_t(gt, table), gt, x.detach())
        assert torch.equal(gg, torch.index_select(x.detach(), -1, table.idx))
    else:
        run = torch.autograd.gradcheck if check == "gradcheck" else torch.autograd.gradgradcheck
        x = _rand(4, table.width).requires_grad_()
        g = _rand(4, table.idx.shape[0], seed=1).requires_grad_()
        assert run(lambda a: gather_last(a, table), (x,))
        assert run(lambda a: gather_last_t(a, table), (g,))


def test_left_out_positions_are_not_summed():
    """A table that keeps every position but the readers of the skewed
    column and a few others: that column reads exactly 0, the rest the
    sums over the kept positions."""
    idx, width = _index("skewed")
    keep = (idx != 2) & (np.arange(idx.shape[0]) % 7 != 3)
    table = _table("skewed", keep)
    g = _rand(5, idx.shape[0])
    out = gather_last_t(g, table)
    ref = torch.zeros(5, width, dtype=torch.float64).index_add_(-1, table.idx, g * torch.as_tensor(keep))
    assert torch.equal(out[:, 2], torch.zeros(5, dtype=torch.float64))
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("fn", ["gather_last", "gather_last_t"])
def test_partial_table_is_not_an_adjoint(fn):
    """A table that leaves positions out is no transpose pair: gradcheck
    fails on either Function (gather_last's backward drops the left-out
    positions' gradient; gather_last_t's backward, the full gather, is not
    0 there), so such a table is right only under its caller's invariant
    (``tp.cm_tables``)."""
    idx, width = _index("skewed")
    table = _table("skewed", idx != 2)
    assert table.partial
    if fn == "gather_last":
        f, arg = (lambda a: gather_last(a, table)), _rand(4, table.width)
    else:
        f, arg = (lambda a: gather_last_t(a, table)), _rand(4, table.idx.shape[0], seed=1)
    assert not torch.autograd.gradcheck(f, (arg.requires_grad_(),), raise_exception=False)


def _dtp_cm_index_select(prog, x1, x2, weight, x1_component_major):
    """``apply_dtp_cm`` as it was written with ``torch.index_select``."""
    X, C, W = (torch.as_tensor(t.reshape(-1)) for t in ttp._cm_gather(prog, x1_component_major))
    A = torch.nn.functional.pad(x2 @ torch.as_tensor(ttp._cm_meta(prog)[1], dtype=x2.dtype), (0, 1))
    prod = torch.index_select(x1, -1, X) * torch.index_select(A, -1, C)
    terms = prod.reshape(*prod.shape[:-1], -1, W.shape[0]).unbind(-2)
    acc = terms[0]
    for term in terms[1:]:
        acc = acc + term
    return acc * torch.index_select(weight, -1, W)


def _program(name):
    return ttp.dtp_instructions(*(Irreps(s) for s in PROGRAMS[name]))


def _check_against_index_select(prog, x1_component_major):
    """apply_dtp_cm's output and its first- and second-order gradients for
    x1, x2 and the weights equal those of the index_select form."""
    inputs = [_rand(6, d, seed=s) for s, d in enumerate((prog.irreps_in1.dim, prog.irreps_in2.dim,
                                                         prog.weight_numel))]
    out_g = _rand(6, len(ttp.cm_input_perm(prog)), seed=5)
    results = []
    for fn in (ttp.apply_dtp_cm, _dtp_cm_index_select):
        leaves = [t.clone().requires_grad_() for t in inputs]
        y = fn(prog, *leaves, x1_component_major=x1_component_major)
        grads = torch.autograd.grad(y, leaves, out_g, create_graph=True)
        second = torch.autograd.grad(sum((g * g).sum() for g in grads), leaves)
        results.append((y.detach(), [g.detach() for g in grads], second))
    (y, grads, second), (ref_y, ref_grads, ref_second) = results
    torch.testing.assert_close(y, ref_y, rtol=0, atol=1e-12)
    for a, b in zip(grads + list(second), ref_grads + list(ref_second)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("x1_component_major", [False, True], ids=["canonical", "component_major"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_apply_dtp_cm_gradients_match_index_select(name, x1_component_major):
    """First- and second-order gradients for x1, x2 and the weights (the
    critic's score trains through the second order)."""
    _check_against_index_select(_program(name), x1_component_major)


CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "diffusion_edf_tpu_torch", "configs")


@pytest.mark.parametrize("family", ["panda_bottle", "panda_bowl", "panda_mug", "sapien", "sapien_bottle"])
def test_shipped_models_hold_the_partial_tables_invariant(family):
    """For every component-major program that a model of the family's
    configs builds, in both input layouts: the positions the X and C tables
    leave out are exactly the readers of A's zero column, whose own
    segment is empty, W is full, and the gradients of any order equal
    those of the index_select form (the left-out positions' gradient is 0
    or discarded)."""
    from diffusion_edf_tpu_torch.nn.tp_modules import DepthwiseTP
    from diffusion_edf_tpu_torch.train.factory import build_score_model
    from diffusion_edf_tpu_torch.train.trainer import load_configs

    programs = set()
    for cfg_dir in sorted(glob.glob(os.path.join(CONFIGS, family, "*", "score_model_configs.yaml"))):
        cfg = load_configs(os.path.dirname(cfg_dir))[2]
        model = build_score_model(cfg["model_name"], cfg["model_kwargs"])
        programs |= {m.program for m in model.modules() if isinstance(m, DepthwiseTP) and ttp.cm_eligible(m.program)}
    assert programs
    like = torch.zeros((), dtype=torch.float64)
    for prog in programs:
        nA = ttp._cm_meta(prog)[1].shape[1]
        for x1_component_major in (False, True):
            X, C, W = ttp.cm_tables(prog, x1_component_major, like)
            assert X.partial and C.partial and not W.partial
            zero_readers = (C.idx == nA).numpy()
            for table in (X, C):
                kept = np.zeros(table.idx.shape[0], dtype=bool)
                kept[table.lanes.numpy()] = True
                assert np.array_equal(~kept, zero_readers)
            assert C.ptr[nA] == C.ptr[nA + 1]
            _check_against_index_select(prog, x1_component_major)


@pytest.mark.parametrize("what", ["gather", "apply_dtp_cm"])
def test_backward_is_bit_equal_twice(what):
    if what == "gather":
        table = _table("skewed")
        x = _rand(16, table.width).requires_grad_()
        fn, leaves, g = (lambda: gather_last(x, table)), [x], _rand(16, table.idx.shape[0], seed=2)
    else:
        prog = _program("tiny")
        leaves = [_rand(9, d, seed=s).requires_grad_() for s, d in enumerate(
            (prog.irreps_in1.dim, prog.irreps_in2.dim, prog.weight_numel))]
        fn, g = (lambda: ttp.apply_dtp_cm(prog, *leaves)), _rand(9, len(ttp.cm_input_perm(prog)), seed=3)
    first = torch.autograd.grad(fn(), leaves, g)
    again = torch.autograd.grad(fn(), leaves, g)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
