"""The port's static tables (irreps algebra, w3j / SH constants, the tensor
product planners, layout permutations and the edge-kernel plan) equal the
JAX package's exactly.  Also holds the helpers the other ``test_torch_*``
files share for moving parameters between the two packages."""
from collections import defaultdict

import jax
import numpy as np
import pytest
import torch

from diffusion_edf_tpu.geom import cg as jcg
from diffusion_edf_tpu.geom import irreps as jir
from diffusion_edf_tpu.nn import edge_kernel as jek
from diffusion_edf_tpu.nn import tp as jtp
from diffusion_edf_tpu_torch.data import stack_points
from diffusion_edf_tpu_torch.geom import cg as tcg
from diffusion_edf_tpu_torch.geom import irreps as tir
from diffusion_edf_tpu_torch.nn import edge_kernel as tek
from diffusion_edf_tpu_torch.nn import tp as ttp
from diffusion_edf_tpu_torch.weights import flax_key, load_flat_params

torch.set_num_threads(1)


# --------------------------------------------------------------------------- #
# shared helpers
# --------------------------------------------------------------------------- #
def flatten_jax(tree) -> dict:
    """Flax param tree -> flat ``a/b/c`` dict of numpy arrays."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(p.key for p in path): np.asarray(v) for path, v in leaves}


def torch_to_jax_params(module: torch.nn.Module) -> dict:
    """A torch module's parameters as flax variables ``{"params": ...}`` (stacked
    groups re-stacked along axis 0)."""
    groups = defaultdict(list)
    for name, p in module.named_parameters():
        key, idx = flax_key(name)
        groups[key].append((idx, p.detach().cpu().numpy()))
    nested: dict = {}
    for key, items in groups.items():
        arr = np.stack([a for _, a in sorted(items)]) if items[0][0] else items[0][1]
        node = nested
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jax.numpy.asarray(arr)
    return nested


def jax_to_torch(module: torch.nn.Module, jax_params) -> torch.nn.Module:
    load_flat_params(module, flatten_jax(jax_params))
    return module


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def one_request(Ts, key_ms, query, time):
    """The ``score`` / ``energy`` arguments of one request as R = 1: poses
    (nT, 7) and times (nT,) given as arrays, the clouds as the model's
    ``get_key_pcd_multiscale`` / ``get_query_pcd`` return them."""
    return t(Ts)[None], [stack_points([p]) for p in key_ms], stack_points([query]), t(time)[None]


# --------------------------------------------------------------------------- #
# tables
# --------------------------------------------------------------------------- #
IRREPS = ["8x0e+4x1e+2x2e", "32x0e+16x1e+8x2e", "64x0e+32x1e+16x2e", "3x0e", "2x0e+1x1o+3x2e+1x3o"]
SH = "1x0e+1x1e+1x2e"


@pytest.mark.parametrize("spec", IRREPS)
def test_irreps_algebra(spec):
    a, b = jir.Irreps(spec), tir.Irreps(spec)
    assert tuple(a) == tuple(b) and repr(a) == repr(b)
    assert (a.dim, a.num_irreps, a.lmax, a.mul_0) == (b.dim, b.num_irreps, b.lmax, b.mul_0)
    assert [s for s in a.slices()] == [s for s in b.slices()]
    assert tuple(a.simplify()) == tuple(b.simplify())
    sa, pa, ia = jir.sort_irreps_even_first(a * 3)
    sb, pb, ib = tir.sort_irreps_even_first(b * 3)
    assert (tuple(sa), list(pa), list(ia)) == (tuple(sb), list(pb), list(ib))


@pytest.mark.parametrize("l1,l2,l3", [(l1, l2, l3) for l1 in range(4) for l2 in range(3)
                                       for l3 in range(abs(l1 - l2), min(l1 + l2, 3) + 1)])
def test_w3j_equal(l1, l2, l3):
    np.testing.assert_array_equal(np.asarray(jcg.w3j(l1, l2, l3)), np.asarray(tcg.w3j(l1, l2, l3)))
    np.testing.assert_array_equal(np.asarray(jcg.w3j_matrix(l1, l2, l3)), np.asarray(tcg.w3j_matrix(l1, l2, l3)))


@pytest.mark.parametrize("l", [2, 3, 4])
def test_sh_recursion_norm_equal(l):
    assert jcg.sh_recursion_norm(l) == tcg.sh_recursion_norm(l)


def _programs(spec_in, spec_edge, spec_out):
    a = jtp.dtp_instructions(jir.Irreps(spec_in), jir.Irreps(spec_edge), jir.Irreps(spec_out))
    b = ttp.dtp_instructions(tir.Irreps(spec_in), tir.Irreps(spec_edge), tir.Irreps(spec_out))
    return a, b


def _same_program(a, b):
    assert tuple(a.irreps_out) == tuple(b.irreps_out)
    assert a.weight_numel == b.weight_numel and a.alpha == b.alpha
    assert [tuple(vars(i).values()) for i in a.instructions] == [tuple(vars(i).values()) for i in b.instructions]


@pytest.mark.parametrize("spec", IRREPS[:3])
def test_tp_planners_equal(spec):
    a, b = _programs(spec, SH, spec)
    _same_program(a, b)
    ta, Ca, sa = jtp._cm_meta(a)
    tb, Cb, sb = ttp._cm_meta(b)
    assert ta == tb and sa == sb
    np.testing.assert_array_equal(Ca, Cb)
    assert jtp.cm_input_perm(a) == ttp.cm_input_perm(b)
    assert jtp.im_perm(jir.Irreps(spec)) == ttp.im_perm(tir.Irreps(spec))
    fa = jtp.fctp_instructions(jir.Irreps(spec), jir.Irreps("2x0e+1x1e"), jir.Irreps(spec))
    fb = ttp.fctp_instructions(tir.Irreps(spec), tir.Irreps("2x0e+1x1e"), tir.Irreps(spec))
    _same_program(fa, fb)


@pytest.mark.parametrize("spec,H", [("8x0e+4x1e+2x2e", 2), ("32x0e+16x1e+8x2e", 4), ("64x0e+32x1e+16x2e", 4)])
def test_edge_plan_equal(spec, H):
    from diffusion_edf_tpu.nn.attention import attn_heads_irreps as j_attn
    from diffusion_edf_tpu_torch.nn.attention import attn_heads_irreps as t_attn

    ja = j_attn(jir.multiply_irreps(spec, 1.0 / H), H)
    ta = t_attn(tir.multiply_irreps(spec, 1.0 / H), H)
    assert tuple(ja) == tuple(ta)
    jp1, tp1 = _programs(spec, SH, spec)
    jp2 = jtp.dtp_instructions(jir.Irreps(spec), jir.Irreps(SH), ja)
    tp2 = ttp.dtp_instructions(tir.Irreps(spec), tir.Irreps(SH), ta)
    ma = ja.mul_0
    jplan = jek.build_edge_plan(jp1, jp2, jir.Irreps(spec), H, ma, ja)
    tplan = tek.build_edge_plan(tp1, tp2, tir.Irreps(spec), H, ma, ta)
    for name in ("mul_alpha", "H", "sd", "gd", "td", "dim_in", "dim_sh", "attn_dim"):
        assert getattr(jplan, name) == getattr(tplan, name), name
    np.testing.assert_array_equal(jplan.R_gate_im, tplan.R_gate_im)
    for jd, td in ((jplan.dtp1, tplan.dtp1), (jplan.dtp2, tplan.dtp2)):
        assert jd.pieces == td.pieces and jd.n_lanes == td.n_lanes and jd.cm_src == td.cm_src
        np.testing.assert_array_equal(jd.C_all, td.C_all)


def test_tf32_is_off():
    """Parity needs full f32 products: importing the port turns TF32 off."""
    import diffusion_edf_tpu_torch  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
