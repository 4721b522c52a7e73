"""Actor-critic loss terms as plain functions on tensors.

Counterpart of the JAX package's ``ops/losses.py`` for the PPO path:
the clipped surrogate, the clipped and plain value losses, and
advantage normalization.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PPOStats(NamedTuple):
    policy_loss: torch.Tensor
    clip_fraction: torch.Tensor
    approx_kl: torch.Tensor


def ppo_clip_loss(
    log_probs: torch.Tensor,
    old_log_probs: torch.Tensor,
    advantages: torch.Tensor,
    *,
    clip_eps: float = 0.2,
) -> PPOStats:
    """Clipped-surrogate PPO policy loss (mean over all leading axes)."""
    log_ratio = log_probs - old_log_probs
    ratio = log_ratio.exp()
    unclipped = ratio * advantages
    clipped = ratio.clamp(1.0 - clip_eps, 1.0 + clip_eps) * advantages
    policy_loss = -torch.minimum(unclipped, clipped).mean()
    with torch.no_grad():
        clip_fraction = ((ratio - 1.0).abs() > clip_eps).float().mean()
        # http://joschu.net/blog/kl-approx.html (k3 estimator)
        approx_kl = (ratio - 1.0 - log_ratio).mean()
    return PPOStats(policy_loss, clip_fraction, approx_kl)


def clipped_value_loss(
    values: torch.Tensor,
    old_values: torch.Tensor,
    targets: torch.Tensor,
    *,
    clip_eps: float = 0.2,
) -> torch.Tensor:
    """PPO-style clipped value loss, 0.5 * max(unclipped, clipped) MSE."""
    clipped = old_values + (values - old_values).clamp(-clip_eps, clip_eps)
    return 0.5 * torch.maximum(
        (values - targets) ** 2, (clipped - targets) ** 2
    ).mean()


def value_loss(values: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return 0.5 * ((values - targets) ** 2).mean()


def normalize_advantages(adv: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``(adv - mean) / (std + eps)`` with the population std, as
    ``jnp.std`` computes it."""
    return (adv - adv.mean()) / (adv.std(correction=0) + eps)
