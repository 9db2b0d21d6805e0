"""The trainer's optimizer, written out to match the JAX package's
``make_optimizer`` (an optax chain) update for update:

    clip_by_global_norm(grad_clip_norm)   when ``grad_clip_norm`` is set
    -> add_decayed_weights(weight_decay)  L2: ``g + weight_decay * p``
    -> amsgrad(lr, betas, eps)            optax's form, below
    -> p - lr(t) * update                 ``lr(t)`` the cosine decay to
                                          ``lr * lr_min_factor`` over
                                          ``total_steps`` when both are set

optax's AMSGrad keeps the running maximum of the bias-corrected second
moment, ``nu_max = max(nu_max, nu / (1 - b2^t))``, and divides the
bias-corrected first moment by ``sqrt(nu_max) + eps``; ``torch.optim.Adam``
with ``amsgrad=True`` takes the maximum of the uncorrected moment, and the
two part in the first steps.  Parameters are updated in place under
``torch.no_grad()``, which bumps their version counters, so every cache of
derived weights (``nn/util.py::cached``) is rebuilt at the next call.

The step count lives on the parameters' device (``count``, an int64
scalar), and the learning rate and the bias corrections are computed from
it there, in float64 and then float32: an update reads no host number that
changes from step to step, so a CUDA graph that captures it applies the
right rate at every replay (``train/trainer.py``)."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["Amsgrad"]


class Amsgrad:
    def __init__(
        self,
        params: Sequence[torch.Tensor],
        lr: float = 3e-4,
        betas: Sequence[float] = (0.9, 0.98),
        eps: float = 1e-9,
        weight_decay: float = 0.0,
        grad_clip_norm: Optional[float] = None,
        lr_min_factor: Optional[float] = None,
        total_steps: Optional[int] = None,
    ):
        """Arguments as ``optimizer_kwargs`` of ``train_configs.yaml`` name
        them (other keys there, such as ``amsgrad``, are ignored)."""
        self.params = list(params)
        self.lr = float(lr)
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.grad_clip_norm = float(grad_clip_norm) if grad_clip_norm else None
        self.decay_steps = int(total_steps) if (lr_min_factor is not None and total_steps) else None
        self.lr_min_factor = float(lr_min_factor) if lr_min_factor is not None else None
        self.count = torch.zeros((), dtype=torch.int64, device=self.params[0].device)  # updates so far
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]

    @classmethod
    def from_config(cls, params, opt_kwargs: Dict, total_steps: Optional[int] = None) -> "Amsgrad":
        keys = ("lr", "betas", "eps", "weight_decay", "grad_clip_norm", "lr_min_factor")
        return cls(params, total_steps=total_steps, **{k: opt_kwargs[k] for k in keys if k in opt_kwargs})

    def lr_at(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate (float64, on ``count``'s device) of the update
        after ``count`` earlier updates."""
        if self.decay_steps is None:
            return torch.full((), self.lr, dtype=torch.float64, device=count.device)
        c = torch.clamp(count, max=self.decay_steps).to(torch.float64)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / self.decay_steps))
        return self.lr * ((1 - self.lr_min_factor) * cosine + self.lr_min_factor)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update of every parameter from its gradient ``grads[i]``, as
        multi-tensor (``torch._foreach_*``) ops: a few launches for all the
        parameters instead of a few for each."""
        grads = list(grads)
        if self.grad_clip_norm is not None:
            g_norm = global_norm(grads)
            factor = torch.where(g_norm < self.grad_clip_norm, torch.ones_like(g_norm), self.grad_clip_norm / g_norm)
            grads = torch._foreach_mul(grads, factor)
        if self.weight_decay:
            grads = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
        neg_lr = (-self.lr_at(self.count)).to(torch.float32)
        self.count.add_(1)
        n = self.count.to(torch.float64)
        bc1 = (1 - torch.pow(self.b1, n)).to(torch.float32)
        bc2 = (1 - torch.pow(self.b2, n)).to(torch.float32)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(grads, grads), alpha=1 - self.b2)
        torch._foreach_maximum_(self.nu_max, torch._foreach_div(self.nu, bc2))
        denom = torch._foreach_sqrt(self.nu_max)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(update, denom)
        torch._foreach_mul_(update, neg_lr)
        torch._foreach_add_(self.params, update)

    def state_arrays(self) -> Dict[str, List[torch.Tensor]]:
        return dict(mu=self.mu, nu=self.nu, nu_max=self.nu_max)

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor an update writes besides the parameters."""
        return [self.count, *self.mu, *self.nu, *self.nu_max]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``tensors``."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))
