"""Host side of the tensor-core edge kernels (``csrc/edge_segment_mma.cuh``):
the K-chunk schedule and its group records, the TF32 ``hi + lo`` split and the
transposed chunk images of the weights, and the plain version of the fused
attention kernel's compaction.  The kernels themselves run only on a GPU
(``test_torch_cuda.py``); here their operands are read back and their
arithmetic is repeated in numpy float64 from exactly what the device is
given, against the plain segment."""
import numpy as np
import pytest
import torch

from diffusion_edf_tpu_torch.geom.sh import spherical_harmonics
from diffusion_edf_tpu_torch.nn import edge_kernel as tek
from diffusion_edf_tpu_torch.nn import fused_attention as tfa
from diffusion_edf_tpu_torch.nn.attention import GraphAttention, _head_of_col
from diffusion_edf_tpu_torch.nn.util import sigmoid_norm, silu_norm, smooth_leaky_relu_norm
from diffusion_edf_tpu_torch.weights import init_params

torch.set_num_threads(1)
SH = "1x0e+1x1e+1x2e"
WIDTHS = {
    "tiny": ("8x0e+4x1e+2x2e", 2, (8, 16)),
    "extractor": ("32x0e+16x1e+8x2e", 4, (32, 16, 16)),
    "tensor_field": ("64x0e+32x1e+16x2e", 4, (128, 128, 64)),
}


def _ga(width, seed=0):
    irreps, heads, fc = WIDTHS[width]
    return init_params(GraphAttention(irreps, SH, irreps, fc_neurons=fc, num_heads=heads),
                       torch.Generator().manual_seed(seed))


def _unimage(img: torch.Tensor) -> np.ndarray:
    """Chunk images back to (n, K): ``(chunks, 16 / T, n, T)``, or with a
    leading hi / lo axis of parts that add up."""
    w = img.double().numpy()
    if w.ndim == 5:
        w = w[:, 0] + w[:, 1]
    chunks, q, n, T = w.shape
    return w.transpose(2, 0, 1, 3).reshape(n, chunks * q * T)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_chunk_schedule_covers_every_lane_once_in_order(width):
    plan = _ga(width).plan
    for dtp in (plan.dtp1, plan.dtp2):
        lane_src, lane0, group_piece = tek.chunk_schedule(dtp)
        assert len(lane_src) % 16 == 0 and len(group_piece) * 8 == len(lane_src)
        real = lane_src[lane_src >= 0]
        np.testing.assert_array_equal(real, np.arange(dtp.n_lanes))  # every lane once, in order
        for p, (_off, mul1, _iks, _ws, lane) in enumerate(dtp.pieces):
            assert lane0[p] % 8 == 0
            np.testing.assert_array_equal(lane_src[lane0[p] : lane0[p] + mul1], np.arange(lane, lane + mul1))
            groups = np.flatnonzero(group_piece == p)
            np.testing.assert_array_equal(groups, lane0[p] // 8 + np.arange(-(-mul1 // 8)))
        if width != "tiny":  # pieces of 8, 16, 32 and 64 lanes need no padding inside
            assert len(lane_src) == -(-dtp.n_lanes // 16) * 16


@pytest.mark.parametrize("width", list(WIDTHS))
def test_group_records_resolve_the_pieces(width):
    plan = _ga(width).plan
    for dtp, weighted in ((plan.dtp1, True), (plan.dtp2, False)):
        lane_src, lane0, group_piece = tek.chunk_schedule(dtp)
        rec = tek.group_records(dtp, weighted)
        assert rec.shape == (len(group_piece), 16) and rec.min() >= -1 and rec.max() < 2 ** 31
        for gi, p in enumerate(group_piece):
            if p < 0:
                assert rec[gi, 1] == 0 and rec[gi, 2] == 0
                continue
            off, mul1, iks, ws, _lane = dtp.pieces[p]
            u0 = gi * 8 - lane0[p]
            assert rec[gi, 0] == off + u0 and rec[gi, 1] == min(8, mul1 - u0) and rec[gi, 2] == len(iks)
            assert rec[gi, 3] == (ws + u0 if weighted else -1)
            assert rec[gi, 0] % 2 == 0 and rec[gi, 1] % 2 == 0 and (not weighted or rec[gi, 3] % 2 == 0)
            assert [(t >> 16, t & 0xFFFF) for t in rec[gi, 5 : 5 + len(iks)]] == [(i * mul1, c) for i, c in iks]


def test_split_tf32_adds_back_and_has_tf32_mantissas():
    rng = np.random.default_rng(0)
    w = torch.as_tensor((rng.normal(size=4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(np.float32))
    hi, lo = tek.split_tf32(w)
    for part in (hi, lo):  # the low 13 bits of the float32 are zero: a TF32 product reads it exactly
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    back = hi.double() + lo.double()
    assert float(((back - w.double()).abs() / w.double().abs()).max()) <= 2.0 ** -21
    assert float(((hi.double() - w.double()).abs() / w.double().abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("width", ["tiny", "extractor"])
@pytest.mark.parametrize("mixed", [False, True])
def test_transposed_chunk_images_equal_the_weights(width, mixed):
    m = _ga(width)
    with torch.no_grad():
        weights, rad = m._kernel_weights()
        if mixed:
            weights = tek.weights_bf16(weights)
        ops = tek.mma_operands(m.plan, weights, rad)
    assert ops["W1"].dtype == (torch.bfloat16 if mixed else torch.float32) and ops["W2"].dtype == torch.float32
    for key, W, dtp in (("W1", weights[0], m.plan.dtp1), ("W2", weights[3], m.plan.dtp2)):
        lane_src, _, _ = tek.chunk_schedule(dtp)
        Wt = _unimage(ops[key])  # (n_pad, K_pad)
        assert Wt.shape == (-(-W.shape[1] // 32) * 32, len(lane_src))
        atol = 0.0 if key == "W1" and mixed else 2.0 ** -21 * float(W.abs().max())
        np.testing.assert_allclose(Wt[: W.shape[1], lane_src >= 0], W.double().numpy().T, rtol=0, atol=atol)
        assert np.all(Wt[W.shape[1] :] == 0) and np.all(Wt[:, lane_src < 0] == 0)
    n_w = rad[1][-2].shape[1]
    assert ops["Rw"].shape[1] % 64 == 0 and torch.equal(ops["Rw"][:, :n_w], rad[1][-2])
    assert torch.equal(ops["Rb"][:n_w], rad[1][-1].reshape(-1)) and float(ops["Rw"][:, n_w:].abs().sum()) == 0
    # built once per set of weights and radial MLP, and again when the radial MLP changes
    assert tek.mma_operands(m.plan, weights, rad) is ops
    with torch.no_grad():
        rad[1][-1].mul_(2.0)
        again = tek.mma_operands(m.plan, weights, rad)
    assert again is not ops and torch.equal(again["Rb"][:n_w], rad[1][-1].reshape(-1))


def _emulate(plan, x1, attr, es, weights, rad):
    """The tensor-core kernels' arithmetic in numpy float64, from the int32
    tables and the weight operands the device is given."""
    spec, arrays = rad
    rad_dims = tek._rad_dims(spec, arrays)
    ops = tek.mma_operands(plan, weights, rad)
    meta = tek._mma_tables(plan, spec, rad_dims)
    n1, n2 = ops["W1"].shape[0], ops["W2"].shape[0]
    g1, g2 = meta[: 32 * n1].reshape(-1, 16), meta[32 * n1 : 32 * (n1 + n2)].reshape(-1, 16)
    rest = meta[32 * (n1 + n2) :]
    gate_idx, dims = rest[: plan.td if plan.gd else 0], rest[plan.td if plan.gd else 0 :]
    assert tuple(dims) == rad_dims
    Rw, Rb, radh = (ops[k].double().numpy() for k in ("Rw", "Rb", "radh"))
    h, pos = es.astype(np.float64), 0
    for din, dout in zip(rad_dims[:-2], rad_dims[1:-1]):
        W = radh[pos : pos + din * dout].reshape(din, dout)
        b, scale, shift = (radh[pos + din * dout + i * dout : pos + din * dout + (i + 1) * dout] for i in range(3))
        pos += din * dout + 3 * dout
        h = h @ W + b
        mu = h.mean(-1, keepdims=True)
        h = (h - mu) / np.sqrt((h * h).mean(-1, keepdims=True) - mu * mu + 1e-5) * scale + shift
        h = h / (1 + np.exp(-h))

    def dtp(x, A, groups, weighted):
        Y = np.zeros((x.shape[0], len(groups) * 8))
        for gi, rec in enumerate(groups):
            xb, real, nt, wq = (int(v) for v in rec[:4])
            if weighted and real:  # the block of radial weights is one of the two in the ring at this chunk
                assert rec[4] - 1 <= wq // 64 <= rec[4] and wq % 64 + real <= 64 and rec[4] == groups[gi ^ 1][4]
            for j in range(real):
                s = sum(x[:, xb + j + (int(t) >> 16)] * A[:, int(t) & 0xFFFF] for t in rec[5 : 5 + nt])
                Y[:, gi * 8 + j] = s * (h @ Rw[:, wq + j] + Rb[wq + j]) if weighted else s
        return Y

    _, b_av, Dmat, _, b2 = (w.double().numpy() for w in weights)
    attr = attr.astype(np.float64)
    Y1 = dtp(x1.astype(np.float64), attr @ plan.dtp1.C_all, g1, True)
    cmb = (Y1 @ _unimage(ops["W1"]).T)[:, : b_av.shape[1]] + b_av
    ma, sd, gd = plan.mul_alpha, plan.sd, plan.gd
    x = cmb[:, :ma]
    logits = ((0.6 * x + 0.4 * x * np.tanh(0.5 * x)) * smooth_leaky_relu_norm()) @ Dmat
    cr = cmb[:, ma:]
    scal = cr[:, :sd] / (1 + np.exp(-cr[:, :sd])) * silu_norm()
    gated = cr[:, sd + gd :] / (1 + np.exp(-cr[:, sd + gate_idx])) * sigmoid_norm() if gd else cr[:, sd:]
    Y2 = dtp(np.concatenate([scal, gated], -1), attr @ plan.dtp2.C_all, g2, False)
    return logits, (Y2 @ _unimage(ops["W2"]).T)[:, : b2.shape[1]] + b2


@pytest.mark.parametrize("width,atol", [("tiny", 2e-5), ("extractor", 2e-5), ("tensor_field", 3e-4)])
def test_device_operands_reproduce_the_plain_segment(width, atol):
    m = _ga(width)
    rng = np.random.default_rng(1)
    rows = 19
    x1 = rng.normal(size=(rows, m.plan.dim_in)).astype(np.float32)
    attr = spherical_harmonics(SH, torch.as_tensor(rng.normal(size=(rows, 3)).astype(np.float32))).numpy()
    es = rng.normal(size=(rows, WIDTHS[width][2][0])).astype(np.float32)
    with torch.no_grad():
        weights, rad = m._kernel_weights()
        pl, pv = tek.edge_core_plain(m.plan, torch.as_tensor(x1), torch.as_tensor(attr), torch.as_tensor(es),
                                     weights, rad)
        el, ev = _emulate(m.plan, x1, attr, es, weights, rad)
    np.testing.assert_allclose(el, pl.numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(ev, pv.numpy(), rtol=0, atol=atol)


def _masks(nd, k):
    rng = np.random.default_rng(3)
    one = np.zeros((nd, k), bool)
    one[np.arange(nd), (7 * np.arange(nd)) % k] = True
    straddle = np.zeros((nd, k), bool)
    straddle[:, : min(k, 40)] = True
    straddle[1] = True
    straddle[2] = False
    sparse = rng.uniform(size=(nd, k)) < 0.1
    sparse[0] = False
    return {"random": rng.uniform(size=(nd, k)) < 0.8, "sparse": sparse, "all_valid": np.ones((nd, k), bool),
            "all_masked": np.zeros((nd, k), bool), "one_a_row": one, "straddle": straddle}


@pytest.mark.parametrize("pattern", ["random", "sparse", "all_valid", "all_masked", "one_a_row", "straddle"])
def test_compaction_matches_numpy(pattern):
    nd, k, tile = 9, 117, 64
    mask = _masks(nd, k)[pattern]
    slots, rowptr = tfa.compact_plain(torch.as_tensor(mask))
    np.testing.assert_array_equal(slots.numpy(), np.flatnonzero(mask.reshape(-1)))
    np.testing.assert_array_equal(rowptr.numpy(), np.concatenate([[0], np.cumsum(mask.sum(1))]))
    assert slots.dtype == rowptr.dtype == torch.int32
    valid, tiles, fill = tfa.tile_stats(torch.as_tensor(mask))
    assert valid == mask.sum() and tiles == -(-valid // tile) and fill == (valid / (tiles * tile) if tiles else 0.0)
    segs = tfa.tile_segments(slots, rowptr, k, tile)
    assert len(segs) == tiles
    parts = {}  # destination row -> the (tile, part) records it is combined from
    for b, tile_segs in enumerate(segs):
        n_rows = min(tile, valid - b * tile)
        assert tile_segs[0][1] == 0 and tile_segs[-1][2] == n_rows  # segments tile the tile's rows
        for (n, lo, hi, spans, part), nxt in zip(tile_segs, tile_segs[1:] + [None]):
            assert hi > lo and (nxt is None or (nxt[1] == hi and nxt[0] > n))
            np.testing.assert_array_equal(slots.numpy()[b * tile + lo : b * tile + hi] // k, n)
            first, last = rowptr[n].item() // tile, (rowptr[n + 1].item() - 1) // tile
            assert spans == last - first + 1 and first <= b <= last
            if spans == 1:
                assert part is None and hi - lo == mask[n].sum()
            else:  # only a tile's first and last segment can be parts of a longer row
                assert (lo == 0 or hi == n_rows) and part == (0 if rowptr[n].item() < b * tile else 1)
                assert (b, part) not in [bp for v in parts.values() for bp in v]
                parts.setdefault(n, []).append((b, part))
    for n, recs in parts.items():  # every tile of a spanning row publishes exactly one part
        first = rowptr[n].item() // tile
        assert [b for b, _ in recs] == list(range(first, first + len(recs)))
        assert sum(hi - lo for b, _ in recs for nn, lo, hi, _, _ in segs[b] if nn == n) == mask[n].sum()
    if pattern == "straddle":
        assert any(len(v) >= 2 for v in parts.values()) and max(len(v) for v in parts.values()) >= 3


@pytest.mark.parametrize("pattern", ["sparse", "one_a_row", "straddle"])
def test_plain_attention_on_compacted_input_equals_padded(pattern):
    """Dropping the masked slots (every row's valid slots moved to the front,
    K cut to the largest count) changes nothing: a masked slot weighs exactly
    0 and a row without valid slots gives exactly 0."""
    m = _ga("tiny")
    nd, k = 9, 50
    rng = np.random.default_rng(5)
    mask = _masks(nd, k)[pattern]
    msg = rng.normal(size=(nd, k, m.plan.dim_in)).astype(np.float32)
    attr = spherical_harmonics(SH, torch.as_tensor(rng.normal(size=(nd, k, 3)).astype(np.float32))).numpy()
    sc = rng.normal(size=(nd, k, 8)).astype(np.float32)
    pre, post = -rng.uniform(size=(nd, k)).astype(np.float32), rng.uniform(size=(nd, k)).astype(np.float32)
    order = np.argsort(~mask, axis=1, kind="stable")  # valid slots first, in order
    kc = max(1, int(mask.sum(1).max()))
    take = lambda a: np.take_along_axis(a, order.reshape(order.shape + (1,) * (a.ndim - 2)), axis=1)[:, :kc]
    hoc = _head_of_col(m.irreps_head, m.H, m.irreps_attn.dim)
    with torch.no_grad():
        weights, rad = m._kernel_weights()
        full = tfa.fused_attention_plain(m.plan, hoc, *map(torch.as_tensor, (msg, attr, sc, mask, pre, post)),
                                         weights, rad)
        small = tfa.fused_attention_plain(m.plan, hoc, *[torch.as_tensor(take(a)) for a in
                                                         (msg, attr, sc, mask, pre, post)], weights, rad)
    torch.testing.assert_close(small, full, rtol=0, atol=1e-6)
    empty = ~mask.any(1)
    assert float(full[torch.as_tensor(empty)].abs().sum()) == 0.0


def test_sass_count_reads_one_function():
    """``cuda_build.count_in_functions`` counts an instruction in the functions
    whose name holds the given part, on text laid out as ``cuobjdump -sass``
    prints it."""
    from diffusion_edf_tpu_torch.nn.cuda_build import count_in_functions

    sass = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _ZN12_GLOBAL__N_117edge_kernel_mixedILi88ELi64EEEvN8edge_mma3CfgE",
        "        /*0a10*/                   HGMMA.64x88x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "        /*0a20*/                   HGMMA.64x64x8.F32.TF32 R88, gdesc[UR8], R88 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_115edge_kernel_f32ILi88ELi64EEEvN8edge_mma3CfgE",
        "        /*0b10*/                   HGMMA.64x88x8.F32.TF32 R24, gdesc[UR4], R24 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_114compact_kernelEPKhiiPiS2_S2_Pfi",
        "        /*0010*/                   SHFL.UP PT, R3, R2, 0x1, RZ ;",
    ])
    assert count_in_functions(sass, "HGMMA") == 3
    assert count_in_functions(sass, "HGMMA", "edge_kernel_f32") == 1
    assert count_in_functions(sass, "HGMMA", "edge_kernel_mixed") == 2
    assert count_in_functions(sass, "HGMMA", "compact_kernel") == 0
