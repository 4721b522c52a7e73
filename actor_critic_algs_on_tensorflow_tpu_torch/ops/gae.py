"""Generalized Advantage Estimation over the backward linear scan.

Counterpart of the JAX package's ``ops/gae.py``. The recursion

    delta_t = r_t + gamma * (1 - d_t) * V(s_{t+1}) - V(s_t)
    A_t     = delta_t + gamma * lambda * (1 - d_t) * A_{t+1}

is a linear backward recurrence over the time axis, computed by
:func:`ops.linear_scan.linear_backward_scan`: the CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor.
"""

from __future__ import annotations

import torch

from actor_critic_algs_on_tensorflow_tpu_torch.ops.linear_scan import (
    linear_backward_scan,
)


def gae_advantages(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    last_value: torch.Tensor,
    *,
    gamma: float = 0.99,
    lam: float = 0.95,
    terminations: torch.Tensor | None = None,
    truncation_values: torch.Tensor | None = None,
    use_pallas: bool = False,
):
    """Compute GAE(lambda) advantages and value targets.

    Args:
      rewards: ``[T, ...]`` rewards for steps ``0..T-1``.
      values: ``[T, ...]`` value estimates ``V(s_t)``.
      dones: ``[T, ...]`` episode-boundary flags for step ``t`` (1.0
        where ``s_{t+1}`` began a new episode; cuts the recursion).
      last_value: ``[...]`` value estimate for ``s_T`` (bootstrap).
      gamma: discount factor.
      lam: GAE lambda.
      terminations: optional ``[T, ...]`` flags marking true terminal
        transitions. Where an episode ended by time-limit truncation
        instead (``dones=1`` but ``terminations=0``), the one-step
        target bootstraps from ``truncation_values``. When omitted,
        ``dones`` is used (truncation treated as terminal).
      truncation_values: optional ``[T, ...]`` ``V(final_obs_t)`` used
        as the bootstrap at truncated steps (pre-auto-reset obs).
      use_pallas: kept so configs and call sites carry over from the
        JAX package; it chooses nothing here. The route follows the
        device: a CUDA tensor always goes through the CUDA kernel, a
        CPU tensor through the plain version.

    Returns:
      ``(advantages, returns)`` each ``[T, ...]``; ``returns`` are the
      lambda-returns ``A_t + V(s_t)`` used as value-function targets.
    """
    del use_pallas
    dones = dones.to(rewards.dtype)
    values_tp1 = torch.cat([values[1:], last_value[None]], dim=0)
    if terminations is None or truncation_values is None:
        bootstrap_cut = dones
    else:
        bootstrap_cut = terminations.to(rewards.dtype)
        truncated = dones * (1.0 - bootstrap_cut)
        values_tp1 = torch.where(truncated > 0.5, truncation_values, values_tp1)
    deltas = rewards + gamma * (1.0 - bootstrap_cut) * values_tp1 - values
    advantages = linear_backward_scan(deltas, gamma * lam * (1.0 - dones))
    return advantages, advantages + values


def discounted_returns(
    rewards: torch.Tensor,
    dones: torch.Tensor,
    last_value: torch.Tensor,
    *,
    gamma: float = 0.99,
) -> torch.Tensor:
    """Plain discounted bootstrapped returns (A3C-style n-step targets)."""
    dones = dones.to(rewards.dtype)
    return linear_backward_scan(
        rewards, gamma * (1.0 - dones), init=last_value.to(rewards.dtype)
    )
