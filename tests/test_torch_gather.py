"""The constant-table gather pair of ``nn/gather.py`` on the CPU (its plain
CSR reduction), in float64: ``gather_last`` / ``gather_last_t`` against
``torch.index_select``'s autograd, first and second order; a table that
leaves positions out, and that such a table is no adjoint pair;
``tp.apply_dtp_cm``'s gradients against its former ``index_select`` form
on real programs in both input layouts, and on every program the shipped
models build; ``IrrepsLinear``'s weight assembly, whose tables leave out
the readers of its appended zero element, on every linear layer the
shipped models build, and with autograd off (the same values, no CSR
built); and bit-equal repeated backward passes.  The CUDA kernel's
cases are in ``tests/test_torch_cuda.py``."""
import functools
import glob
import os

import numpy as np
import pytest
import torch

from diffusion_edf_tpu_torch.geom.irreps import Irreps
from diffusion_edf_tpu_torch.nn import tp as ttp
from diffusion_edf_tpu_torch.nn import util as tutil
from diffusion_edf_tpu_torch.nn.gather import csr, gather_last, gather_last_t, gather_table
from diffusion_edf_tpu_torch.nn.layers import IrrepsLinear

SH = "1x0e+1x1e+1x2e"
PROGRAMS = {  # the tests' tiny width and the shipped pick models' width
    "tiny": ("8x0e+4x1e+2x2e", SH, "8x0e+4x1e+2x2e"),
    "pick": ("64x0e+32x1e+16x2e", SH, "64x0e+32x1e+16x2e"),
}


def _tiny_linear(seed: int = 3) -> IrrepsLinear:
    """A small ``IrrepsLinear`` with both lane permutations (drawn from
    ``seed``) and outputs that no input degree reaches (entries that read
    the zero element)."""
    rng = np.random.default_rng(seed)
    layer = IrrepsLinear("3x0e+2x1e", "2x0e+2x1e+1x2e", input_perm=tuple(int(i) for i in rng.permutation(9)),
                         output_perm=tuple(int(i) for i in rng.permutation(13)))
    for i, p in enumerate(layer.parameters()):
        p.data = _rand(*p.shape, seed=10 + i)
    return layer


def _index(kind: str):
    """``(idx, width)``: every column read by a few positions, or one column
    (like apply_dtp_cm's zero column) read by most of them, or a linear
    layer's weight assembly (each weight read by an irrep's components, the
    zero element past them by the entries no input degree reaches)."""
    rng = np.random.default_rng(0)
    if kind == "uniform":
        return rng.integers(0, 7, size=23), 7
    if kind == "linear":
        W_idx = _tiny_linear()._index(True)[0]
        return W_idx, int(W_idx.max()) + 1
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


@pytest.mark.parametrize("kind", ["uniform", "skewed", "linear"])
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


@pytest.mark.parametrize("what", ["gather", "apply_dtp_cm", "irreps_linear"])
def test_backward_is_bit_equal_twice(what):
    if what == "irreps_linear":
        layer = _tiny_linear()
        leaves = list(layer.parameters())
        fn, g = (lambda: torch.cat([t.reshape(-1) for t in layer._gather(True)])), _rand(13 * 9 + 13, seed=4)
    elif what == "gather":
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


# ---- IrrepsLinear's weight assembly (nn/layers.py) through the pair ----


def _linear_index_select(layer, permuted):
    """``IrrepsLinear._gather`` as it was written with ``torch.index_select``
    alone."""
    W_i, B_i = (torch.as_tensor(t) for t in layer._index(permuted))
    ws = [((getattr(layer, n) - 1.0) / float(np.sqrt(m))).reshape(-1) for n, m in layer.w_names.values()]
    zero = W_i.new_zeros(1, dtype=torch.float64)
    W = torch.index_select(torch.cat(ws + [zero]), 0, W_i).reshape(layer.irreps_in.dim, layer.irreps_out.dim)
    return W, torch.index_select(torch.cat([getattr(layer, n) for n in layer.b_names.values()] + [zero]), 0, B_i)


@functools.lru_cache(maxsize=None)
def _shipped_linears(family: str):
    """One ``IrrepsLinear`` of each distinct table key (irreps, bias, lane
    permutations) in the models of the family's configs, in float64 with
    random params."""
    from diffusion_edf_tpu_torch.train.factory import build_score_model
    from diffusion_edf_tpu_torch.train.trainer import load_configs

    layers = {}
    for cfg_file in sorted(glob.glob(os.path.join(CONFIGS, family, "*", "score_model_configs.yaml"))):
        cfg = load_configs(os.path.dirname(cfg_file))[2]
        model = build_score_model(cfg["model_name"], cfg["model_kwargs"])
        for m in model.modules():
            if isinstance(m, IrrepsLinear) and (m.w_names or m.b_names):
                layers.setdefault(m._key(True), m)
    out = []
    for i, m in enumerate(layers.values()):
        m = IrrepsLinear(m.irreps_in, m.irreps_out, bool(m.b_names), m.input_perm, m.output_perm).double()
        for j, p in enumerate(m.parameters()):
            p.data = _rand(*p.shape, seed=100 * i + j)
        out.append(m)
    return tuple(out)


FAMILIES = ["panda_bottle", "panda_bowl", "panda_mug", "sapien", "sapien_bottle"]


@pytest.mark.parametrize("family", FAMILIES)
def test_shipped_linears_hold_the_partial_tables_invariant(family):
    """For every ``IrrepsLinear`` the family's models build, in both
    layouts: the positions its W and bias tables leave out are exactly
    those that read the last column, whose own segment is empty; that
    column is the zero element appended past every parameter (the
    columns before it are the flattened params, one each), and the
    gathered W and bias are the ``index_select`` form's, bit for bit."""
    like = torch.zeros((), dtype=torch.float64)
    layers = _shipped_linears(family)
    assert layers
    for layer in layers:
        n_w = sum(getattr(layer, n).numel() for n, _ in layer.w_names.values())
        n_b = sum(getattr(layer, n).numel() for n in layer.b_names.values())
        for permuted in (True, False):
            tables = layer.gather_tables(permuted, like)
            for table, n_params in zip(tables, (n_w, n_b)):
                assert table.partial and table.width == n_params + 1
                kept = np.zeros(table.idx.shape[0], dtype=bool)
                kept[table.lanes.numpy()] = True
                assert np.array_equal(~kept, (table.idx == n_params).numpy())
                assert table.ptr[n_params] == table.ptr[n_params + 1] == table.lanes.shape[0]
            # every parameter is read: the only column no position reads is none of them
            assert bool((tables[0].ptr[1:n_w + 1] > tables[0].ptr[:n_w]).all())
            got, ref = layer._gather(permuted), _linear_index_select(layer, permuted)
            assert got[0].grad_fn is not None and all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("family", FAMILIES)
def test_shipped_linear_gradients_match_index_select(family):
    """First- and second-order gradients, in float64, of each distinct
    ``IrrepsLinear`` the family's models build (its forward on random
    features, in its permuted layout): the params' and the features'
    through the pair equal those through ``index_select``'s own
    backward."""
    for i, layer in enumerate(_shipped_linears(family)):
        f = _rand(3, layer.irreps_in.dim, seed=1000 + i)
        out_g = _rand(3, layer.irreps_out.dim, seed=2000 + i)
        leaves = [f] + list(layer.parameters())
        results = []
        for gather in (lambda: layer._gather(True), lambda: _linear_index_select(layer, True)):
            x = f.clone().requires_grad_()
            W, bias = gather()
            y = x @ W + bias
            grads = torch.autograd.grad(y, [x] + leaves[1:], out_g, create_graph=True)
            second = torch.autograd.grad(sum((g * g).sum() for g in grads), [x] + leaves[1:], allow_unused=True,
                                         materialize_grads=True)
            results.append([g.detach() for g in grads] + list(second))
        for a, b in zip(*results):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode,seed", [("no_grad", 5), ("frozen", 6)])
def test_linear_without_autograd_builds_no_csr(mode, seed):
    """Where autograd records nothing (grad mode off, or params that need no
    gradient), ``W`` and ``bias`` are the ``index_select`` form's, bit for
    bit, and no CSR is built; with autograd on they are the same, and the
    CSR of the layer's tables is built at the first backward, not before
    (each case's layer has lane permutations of its own, so no other case
    built its tables)."""
    layer = _tiny_linear(seed)

    def built():
        return [k for k in tutil._CONSTANTS if k[0][0] in ("gather_ptr", "gather_lanes")
                and k[0][1][:-1] == layer._key(True)]

    with torch.no_grad():
        ref = _linear_index_select(layer, True)
    if mode == "no_grad":
        with torch.no_grad():
            got = layer._dense()
    else:
        layer.requires_grad_(False)
        got = layer._dense()
        assert got[0].grad_fn is None
    assert not built()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    layer.requires_grad_(True)
    pair = layer._dense()
    assert pair[0].grad_fn is not None and all(torch.equal(a, b) for a, b in zip(pair, ref))
    assert not built()
    (pair[0].sum() + pair[1].sum()).backward()
    assert len(built()) == 4  # ptr and lanes of W and of bias
