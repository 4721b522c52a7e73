"""CartPole-v1 as a batched on-device environment.

Counterpart of ``CartPole`` in the JAX package's ``envs/cartpole.py``:
the classic Barto-Sutton-Anderson cart-pole as standardized by
Gym/Gymnasium (Euler integration, tau=0.02, 500-step truncation).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from actor_critic_algs_on_tensorflow_tpu_torch.envs.core import Box, Discrete, Env


@dataclasses.dataclass(frozen=True)
class CartPoleParams:
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    length: float = 0.5  # half the pole's length
    force_mag: float = 10.0
    tau: float = 0.02
    theta_threshold: float = 12.0 * math.pi / 180.0
    x_threshold: float = 2.4
    max_steps: int = 500


@dataclasses.dataclass
class CartPoleState:
    x: torch.Tensor          # [B] float32
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor          # [B] int32 step counter for truncation


class CartPole(Env[CartPoleState, CartPoleParams]):
    name = "CartPole-v1"

    def default_params(self) -> CartPoleParams:
        return CartPoleParams()

    def reset(self, generator, params, num_envs):
        vals = torch.rand(
            (num_envs, 4), generator=generator, device=generator.device
        ) * 0.1 - 0.05
        state = CartPoleState(
            x=vals[:, 0],
            x_dot=vals[:, 1],
            theta=vals[:, 2],
            theta_dot=vals[:, 3],
            t=torch.zeros(num_envs, dtype=torch.int32, device=generator.device),
        )
        return state, self._obs(state)

    def step(self, generator, state, action, params):
        del generator
        force = torch.where(action == 1, params.force_mag, -params.force_mag)
        costheta = torch.cos(state.theta)
        sintheta = torch.sin(state.theta)
        total_mass = params.masscart + params.masspole
        polemass_length = params.masspole * params.length

        temp = (
            force + polemass_length * state.theta_dot**2 * sintheta
        ) / total_mass
        theta_acc = (params.gravity * sintheta - costheta * temp) / (
            params.length
            * (4.0 / 3.0 - params.masspole * costheta**2 / total_mass)
        )
        x_acc = temp - polemass_length * theta_acc * costheta / total_mass

        new_state = CartPoleState(
            x=state.x + params.tau * state.x_dot,
            x_dot=state.x_dot + params.tau * x_acc,
            theta=state.theta + params.tau * state.theta_dot,
            theta_dot=state.theta_dot + params.tau * theta_acc,
            t=state.t + 1,
        )
        terminated = (
            (new_state.x.abs() > params.x_threshold)
            | (new_state.theta.abs() > params.theta_threshold)
        ).float()
        truncated = (new_state.t >= params.max_steps).float()
        done = torch.maximum(terminated, truncated)
        reward = torch.ones_like(done)
        info: Dict[str, torch.Tensor] = {
            "terminated": terminated,
            "truncated": truncated,
        }
        return new_state, self._obs(new_state), reward, done, info

    def _obs(self, state: CartPoleState) -> torch.Tensor:
        return torch.stack(
            [state.x, state.x_dot, state.theta, state.theta_dot], dim=-1
        ).float()

    def observation_space(self, params):
        return Box(-math.inf, math.inf, (4,))

    def action_space(self, params):
        return Discrete(2)
