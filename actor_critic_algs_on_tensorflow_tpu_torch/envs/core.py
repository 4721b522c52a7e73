"""Batched on-device environment API.

Counterpart of the JAX package's ``envs/core.py``. There an environment
is written for one instance and vectorized with ``vmap``; here every
environment is written for a batch: state fields and observations carry
a leading ``[B]`` env axis, and randomness comes from an explicit
``torch.Generator`` on the envs' device.

API: an environment is a stateless object with methods

    reset(generator, params, num_envs)         -> (state, obs)
    step(generator, state, action, params)     -> (state, obs, reward, done, info)

``done`` is 1.0 at terminal OR truncation boundaries; ``info`` carries
``terminated``/``truncated`` separately (gymnasium semantics) so value
bootstrapping can distinguish them. State objects are dataclasses whose
fields are tensors or nested states; :func:`tree_map` walks them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Generic, Tuple, TypeVar

import torch

TEnvState = TypeVar("TEnvState")
TParams = TypeVar("TParams")


@dataclasses.dataclass(frozen=True)
class Box:
    """Continuous space with a static shape."""

    low: float
    high: float
    shape: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class Discrete:
    """Discrete space {0, ..., n-1}."""

    n: int = 2


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over dataclass states (tensors are leaves)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree,
            **{
                f.name: tree_map(
                    fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest)
                )
                for f in dataclasses.fields(tree)
            },
        )
    if tree is None:
        return None
    return fn(tree, *rest)


def expand_as(flag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape a ``[B]`` flag to broadcast against ``[B, ...]``."""
    return flag.reshape(flag.shape + (1,) * (x.dim() - flag.dim()))


def tree_where(flag: torch.Tensor, a: Any, b: Any) -> Any:
    """Per env: ``a`` where ``flag``, else ``b``."""
    return tree_map(lambda x, y: torch.where(expand_as(flag, x), x, y), a, b)


class Env(Generic[TEnvState, TParams]):
    """Base class for batched on-device environments."""

    name: str = "Env"

    def default_params(self) -> TParams:
        raise NotImplementedError

    def reset(
        self, generator: torch.Generator, params: TParams, num_envs: int
    ) -> Tuple[TEnvState, torch.Tensor]:
        raise NotImplementedError

    def step(
        self,
        generator: torch.Generator,
        state: TEnvState,
        action: torch.Tensor,
        params: TParams,
    ) -> Tuple[TEnvState, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def observation_space(self, params: TParams):
        raise NotImplementedError

    def action_space(self, params: TParams):
        raise NotImplementedError
