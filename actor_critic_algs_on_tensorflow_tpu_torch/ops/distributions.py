"""Policy distributions as small classes over tensors.

Counterpart of the JAX package's ``ops/distributions.py``:
``Categorical`` (softmax head for discrete control) and
``DiagGaussian``. Sampling draws from an explicit ``torch.Generator``
in place of a ``jax.random`` key.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class Categorical(NamedTuple):
    """Categorical distribution over logits ``[..., A]``."""

    logits: torch.Tensor

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """Gumbel-max draw, as ``jax.random.categorical`` does."""
        u = torch.rand(
            self.logits.shape, generator=generator,
            device=self.logits.device, dtype=self.logits.dtype,
        )
        u = u.clamp_(min=torch.finfo(u.dtype).tiny)
        return torch.argmax(self.logits - torch.log(-torch.log(u)), dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        log_p = torch.log_softmax(self.logits, dim=-1)
        return log_p.gather(-1, actions.long()[..., None])[..., 0]

    def entropy(self) -> torch.Tensor:
        log_p = torch.log_softmax(self.logits, dim=-1)
        return -(log_p.exp() * log_p).sum(-1)

    def kl(self, other: "Categorical") -> torch.Tensor:
        log_p = torch.log_softmax(self.logits, dim=-1)
        log_q = torch.log_softmax(other.logits, dim=-1)
        return (log_p.exp() * (log_p - log_q)).sum(-1)


class DiagGaussian(NamedTuple):
    """Diagonal Gaussian with event shape ``[..., D]``."""

    mean: torch.Tensor
    log_std: torch.Tensor

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        eps = torch.randn(
            self.mean.shape, generator=generator,
            device=self.mean.device, dtype=self.mean.dtype,
        )
        return self.mean + self.log_std.exp() * eps

    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        z = (actions - self.mean) * torch.exp(-self.log_std)
        return (-0.5 * z * z - self.log_std - _LOG_SQRT_2PI).sum(-1)

    def entropy(self) -> torch.Tensor:
        return (self.log_std + 0.5 + _LOG_SQRT_2PI).sum(-1)
