"""PyTorch + CUDA port of the JAX package beside it (SE(3) bi-equivariant diffusion
for pick-and-place), built for an NVIDIA H100.

The JAX package beside this one is the reference: every module here keeps
its counterpart's file layout and names, and the shipped ``.npz``
checkpoints load unchanged (:mod:`.weights`).  This package never imports
jax, flax or the JAX package.

It covers the pick and place requests (``agent``: the cascades and their
EBM critics), serving (``serve``), training (``train.trainer``, the
command line ``train.cli``) and evaluation (``eval``), for the panda and
sapien model families.  At inference the per-edge segment of every
``GraphAttention`` runs through the hand-written CUDA kernels of ``csrc/``
(:mod:`.nn.edge_kernel`, :mod:`.nn.fused_attention`); training runs the
plain PyTorch path, since the kernels have no backward.
"""
import torch

# Parity with the f32 reference needs full-precision f32 products: TF32
# keeps ~10 mantissa bits and alone exceeds the 3e-4 kernel gate and the
# 2e-2 final-pose gate at full width.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
