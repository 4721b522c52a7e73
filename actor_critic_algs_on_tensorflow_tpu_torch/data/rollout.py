"""On-policy trajectory containers and minibatch helpers.

Counterpart of the JAX package's ``data/rollout.py``. The rollout
buffer is a time-major ``Trajectory`` of tensors on the device; these
helpers name its fields and cut it into minibatches. Index draws come
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch


class Trajectory(NamedTuple):
    """Time-major rollout: every field is ``[T, B, ...]``."""

    obs: Any
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    log_probs: torch.Tensor
    values: torch.Tensor


def flatten_time_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """[T, B, ...] -> [T*B, ...] for minibatched updates (views)."""
    return {k: x.reshape((-1,) + tuple(x.shape[2:])) for k, x in batch.items()}


def minibatch_iter_indices(
    generator: torch.Generator, n: int, num_minibatches: int
) -> torch.Tensor:
    """Random permutation of ``n`` split into ``num_minibatches`` index
    blocks, as a ``[num_minibatches, n // num_minibatches]`` tensor."""
    perm = torch.randperm(n, generator=generator, device=generator.device)
    size = n // num_minibatches
    return perm[: size * num_minibatches].reshape(num_minibatches, size)


def take_minibatch(batch: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: x.index_select(0, idx) for k, x in batch.items()}


def env_block_starts(
    generator: torch.Generator, num_minibatches: int, block_envs: int
) -> torch.Tensor:
    """Start offsets of contiguous env blocks, visit order permuted.

    The gather-free minibatch schedule (``PPOConfig.shuffle="env"``):
    the env axis is partitioned into ``num_minibatches`` contiguous
    blocks of ``block_envs`` envs, each minibatch is every rollout step
    of one block, and only the order the blocks are visited in is drawn
    per epoch. Returns ``[num_minibatches]`` int64 starts.
    """
    perm = torch.randperm(
        num_minibatches, generator=generator, device=generator.device
    )
    return perm * block_envs
