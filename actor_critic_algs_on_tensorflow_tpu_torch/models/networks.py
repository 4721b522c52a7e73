"""Policy/value networks as ``nn.Module``s.

Counterpart of the JAX package's ``models/networks.py`` for the
on-policy discrete path: ``MLPTorso``, ``NatureCNN`` and
``DiscreteActorCritic``. Parameters are float32; ``dtype`` is the
compute dtype, as Flax's ``dtype=`` is: inputs, weights and biases are
cast to it for each layer (bfloat16 on the card), and the heads' logits
and value come out as float32.

Layouts follow the JAX package at the public functions: observations
are channels-last ``[..., H, W, C]``. Inside, the NHWC batch is viewed
as NCHW with ``permute`` (no copy; the tensor is then in PyTorch's
channels-last memory format). Weights use
PyTorch's layouts (Linear ``[out, in]``, Conv ``[O, I, kh, kw]``);
``utils.transplant.from_flax`` maps Flax params onto them.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_CONV_LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))  # (features, kernel, stride)


def _orthogonal_(layer: nn.Module, scale: float, generator: torch.Generator | None):
    """Orthogonal weight at ``scale`` and zero bias (Flax's
    ``orthogonal(scale)`` kernel init and zeros bias init)."""
    nn.init.orthogonal_(layer.weight, gain=scale, generator=generator)
    nn.init.zeros_(layer.bias)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MLPTorso(nn.Module):
    """Feed-forward torso; default 2x64 tanh (CartPole-class policies)."""

    def __init__(
        self,
        in_features: int,
        hidden_sizes: Sequence[int] = (64, 64),
        activation: Callable = torch.tanh,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.activation = activation
        sizes = (in_features, *hidden_sizes)
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:])
        )
        for layer in self.layers:
            _orthogonal_(layer, math.sqrt(2.0), generator)
        self.out_features = sizes[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for layer in self.layers:
            x = self.activation(_linear(x, layer, self.dtype))
        return x


def _conv_out(size: int, kernel: int, stride: int) -> int:
    return (size - kernel) // stride + 1


class NatureCNN(nn.Module):
    """Nature-DQN convolutional encoder for 84x84 stacked frames.

    Conv(32,8x8,s4) -> Conv(64,4x4,s2) -> Conv(64,3x3,s1) -> Dense(512),
    ReLU throughout (Mnih et al. 2015). Input ``[..., H, W, C]`` in
    [0, 1] or uint8. uint8 is cast straight to the compute dtype and
    divided by 255 in place, so a bfloat16 batch never has a float32
    copy.

    The conv output is flattened in NHWC order, as Flax flattens it
    (``networks.py:160``), by permuting the NCHW activation back to
    NHWC before the reshape. So the first Dense layer's weight is the
    transpose of Flax's kernel with no row permutation.
    """

    def __init__(
        self,
        obs_shape: Tuple[int, int, int],
        hidden_size: int = 512,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        h, w, c = obs_shape
        convs = []
        for features, kernel, stride in _CONV_LAYERS:
            convs.append(nn.Conv2d(c, features, kernel, stride=stride))
            c = features
            h, w = _conv_out(h, kernel, stride), _conv_out(w, kernel, stride)
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(h * w * c, hidden_size)
        for layer in (*self.convs, self.dense):
            _orthogonal_(layer, math.sqrt(2.0), generator)
        self.out_features = hidden_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            x = x.to(self.dtype).div_(255.0)  # in place on the fresh cast
        else:
            x = x.to(self.dtype)
        batch_shape = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)
        for conv, (_, _, stride) in zip(self.convs, _CONV_LAYERS):
            x = F.relu(
                F.conv2d(
                    x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                    stride=stride,
                )
            )
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(_linear(x, self.dense, self.dtype))
        return x.reshape(batch_shape + (self.out_features,))


class DiscreteActorCritic(nn.Module):
    """Shared-torso policy + value heads for discrete action spaces.

    ``torso='mlp'`` gives the CartPole 2-layer MLP; ``torso='nature_cnn'``
    the Atari encoder. Returns ``(logits [..., A], value [...])`` in
    float32.
    """

    def __init__(
        self,
        obs_shape: Tuple[int, ...],
        num_actions: int,
        torso: str = "mlp",
        hidden_sizes: Sequence[int] = (64, 64),
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        if torso == "nature_cnn":
            self.torso = NatureCNN(tuple(obs_shape), dtype=dtype, generator=generator)
        elif torso == "mlp":
            self.torso = MLPTorso(
                obs_shape[-1], hidden_sizes, dtype=dtype, generator=generator
            )
        else:
            raise NotImplementedError(
                f"torso {torso!r} is not yet ported to the PyTorch package "
                "(ported: 'mlp', 'nature_cnn')"
            )
        self.logits = nn.Linear(self.torso.out_features, num_actions)
        self.value = nn.Linear(self.torso.out_features, 1)
        _orthogonal_(self.logits, 0.01, generator)
        _orthogonal_(self.value, 1.0, generator)

    def forward(self, obs: torch.Tensor):
        z = self.torso(obs)
        logits = _linear(z, self.logits, self.dtype)
        value = _linear(z, self.value, self.dtype)
        return logits.float(), value[..., 0].float()
