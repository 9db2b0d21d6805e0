"""Which phase of a tile the tensor-core edge kernels spend their time in.

    python3 tools/torch_kernel_phases.py

Builds ``csrc/edge_kernel.cu`` and ``csrc/fused_attention.cu`` six times: as
they are, with one phase of the chunk loop left out (``EDGE_MMA_SKIP_BUILD``:
the building of the Y lanes; ``_SKIP_COPY``: the staging of the weights;
``_SKIP_PRODUCTS``: the ``wgmma`` products; ``_SKIP_RADIAL``: the radial MLP's
last layer), and with all four left out (what remains: the hidden radial
layers, ``attr @ C``, logits, gate, and the loop's barriers).  Times the
float32 edge kernel (every row, and given a mask that keeps one row in ten),
the mixed bfloat16 edge kernel and the fused attention kernel (all slots
valid, and one in ten) at the tensor field's shape (7,488 slots of width
240) by the device time of their kernels (``chip_smoke.device_ms``).  What a
variant saves is the time its phase adds to the tile; the variants' results
are wrong and are not looked at.  Needs a CUDA device.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("BUILD", "COPY", "PRODUCTS", "RADIAL")


def main() -> int:
    import torch

    import chip_smoke as cs
    from diffusion_edf_tpu_torch.geom.sh import spherical_harmonics
    from diffusion_edf_tpu_torch.nn import cuda_build
    from diffusion_edf_tpu_torch.nn import edge_kernel as ek
    from diffusion_edf_tpu_torch.nn import fused_attention as fa
    from diffusion_edf_tpu_torch.nn.attention import GraphAttention, _head_of_col
    from diffusion_edf_tpu_torch.weights import init_params

    if not torch.cuda.is_available():
        print("torch_kernel_phases: needs a CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}")
    variants = [()] + [(f"EDGE_MMA_SKIP_{p}",) for p in PHASES] + [tuple(f"EDGE_MMA_SKIP_{p}" for p in PHASES)]
    libs = {name: cuda_build.load_variants(name, variants) for name in cuda_build.SOURCES}

    sh, nd, k = "1x0e+1x1e+1x2e", 64, 117
    ga = GraphAttention("64x0e+32x1e+16x2e", sh, "64x0e+32x1e+16x2e", fc_neurons=(128, 128, 64), num_heads=4)
    ga = init_params(ga, torch.Generator().manual_seed(0)).cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        weights, rad = ga._kernel_weights()
        wb = ek.weights_bf16(weights)
        msg = torch.randn(nd, k, ga.plan.dim_in, generator=g, device="cuda")
        attr = spherical_harmonics(sh, torch.randn(nd, k, 3, generator=g, device="cuda"), eps=1e-4)
        sc = torch.randn(nd, k, 128, generator=g, device="cuda")
        flat = [t.reshape(nd * k, -1) for t in (msg, attr, sc)]
        xb = flat[0].to(torch.bfloat16)
        masks = {"all valid": torch.ones(nd, k, dtype=torch.bool, device="cuda"),
                 "a tenth valid": torch.rand(nd, k, generator=g, device="cuda") < 0.1}
        tenth = masks["a tenth valid"].reshape(-1)
        hoc = _head_of_col(ga.irreps_head, ga.H, ga.irreps_attn.dim)
        for i, defines in enumerate(variants):
            ek._library = lambda lib=ek.bind(libs["edge_kernel"][i]): lib
            fa._library = lambda lib=fa.bind(libs["fused_attention"][i]): lib
            t1 = cs.device_ms(lambda: ek.edge_kernel(ga.plan, *flat, weights, rad))
            t1m = cs.device_ms(lambda: ek.edge_kernel(ga.plan, *flat, weights, rad, mask=tenth))
            t2 = cs.device_ms(lambda: ek.edge_kernel(ga.plan, xb, flat[1], flat[2], wb, rad))
            t3 = {label: cs.device_ms(lambda: fa.fused_attention(ga.plan, hoc, msg, attr, sc, m, None, None, weights, rad))
                  for label, m in masks.items()}
            what = "as built" if not defines else "without " + ", ".join(d[len("EDGE_MMA_SKIP_"):].lower() for d in defines)
            print(f"{what:44s} f32 edge kernel {t1:.4f} ms, a tenth valid {t1m:.4f} ms   mixed edge kernel {t2:.4f} ms"
                  "   fused attention: " + "   ".join(f"{label} {t:.4f} ms" for label, t in t3.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
