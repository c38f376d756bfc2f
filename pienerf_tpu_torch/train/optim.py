"""Adam under an exponential learning-rate decay, skipping non-finite
steps: the JAX trainer's optimizer as plain tensor functions.

``optax.apply_if_finite(optax.adam(optax.exponential_decay(lr, iters,
decay_rate), b1, b2, eps), max_consecutive_errors)``
(pienerf_tpu/train/trainer.py:51-69), with optax's arithmetic in optax's
order:

  mu  = (1 - b1) * g + b1 * mu          nu = (1 - b2) * g^2 + b2 * nu
  c   = count + 1                       u  = mu / (1 - b1^c) /
                                             (sqrt(nu / (1 - b2^c)) + eps)
  step = -(lr * decay_rate ** (k / iters)), k the schedule's own count
  params += step * u

A step whose gradient holds a non-finite value is skipped: the update is
zero and the moments, the Adam count and the schedule's count stay where
they were; ``notfinite_count`` counts consecutive skips, and past
``max_consecutive_errors`` the update is applied anyway. Every decision is
a ``torch.where`` on the device, so a step makes no host sync.
``torch.optim.Adam`` under a ``LambdaLR`` would count differently under
skips.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch


class AdamState(NamedTuple):
    """optax's ApplyIfFiniteState(inner=(ScaleByAdamState,
    ScaleByScheduleState)), flattened; counts are int32 scalars."""
    count: torch.Tensor            # Adam's bias-correction count
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    schedule_count: torch.Tensor   # the learning-rate schedule's count
    notfinite_count: torch.Tensor  # consecutive non-finite steps
    last_finite: torch.Tensor      # bool: the last gradient was finite
    total_notfinite: torch.Tensor


class Adam:
    """``max_consecutive_errors=None`` is plain ``optax.adam`` (every step
    applied), as distillation uses it."""

    def __init__(self, lr: float, total_iters: int,
                 decay_rate: float = 0.1, b1: float = 0.9, b2: float = 0.99,
                 eps: float = 1e-15,
                 max_consecutive_errors: Optional[int] = 100):
        self.lr, self.total_iters, self.decay_rate = lr, total_iters, \
            decay_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.max_errors = max_consecutive_errors

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        dev = params[0].device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return AdamState(
            count=zero, mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params], schedule_count=zero,
            notfinite_count=zero,
            last_finite=torch.zeros((), dtype=torch.bool, device=dev),
            total_notfinite=zero)

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """optax.exponential_decay at ``count`` (f32, transition_begin 0,
        not staircase)."""
        p = count.float() / self.total_iters
        lr = self.lr * torch.pow(
            torch.tensor(self.decay_rate, dtype=torch.float32,
                         device=count.device), p)
        return torch.where(count <= 0, torch.full_like(lr, self.lr), lr)

    def update(self, grads: Sequence[torch.Tensor], state: AdamState
               ) -> Tuple[List[torch.Tensor], AdamState]:
        """(updates to add to the params, new state)."""
        dev = grads[0].device
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        one = torch.ones((), dtype=torch.int32, device=dev)
        nfc = torch.where(finite, torch.zeros_like(one),
                          state.notfinite_count + one)
        if self.max_errors is None:
            apply = torch.ones((), dtype=torch.bool, device=dev)
        else:
            apply = finite | (nfc > self.max_errors)
        b1, b2 = self.b1, self.b2
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + one
        cf = count.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, device=dev), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=dev), cf)
        step = -1.0 * self.learning_rate(state.schedule_count)
        upd = [step * ((m / bc1) / (torch.sqrt(v / bc2 + 0.0) + self.eps))
               for m, v in zip(mu, nu)]
        upd = [torch.where(apply, u, torch.zeros_like(u)) for u in upd]
        new = AdamState(
            count=torch.where(apply, count, state.count),
            mu=[torch.where(apply, a, b) for a, b in zip(mu, state.mu)],
            nu=[torch.where(apply, a, b) for a, b in zip(nu, state.nu)],
            schedule_count=torch.where(apply, state.schedule_count + one,
                                       state.schedule_count),
            notfinite_count=nfc, last_finite=finite,
            total_notfinite=torch.where(finite, state.total_notfinite,
                                        state.total_notfinite + one))
        return upd, new


def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> None:
    """params += updates, in place (optax.apply_updates)."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)
