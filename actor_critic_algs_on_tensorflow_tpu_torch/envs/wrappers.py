"""Composable wrappers on batched envs: frame-stack, auto-reset,
episode stats and the vectorized front.

Counterpart of the JAX package's ``envs/wrappers.py``. Canonical
composition (innermost first):

    VecEnv(EpisodeStats(AutoReset(FrameStack(PongTPU(), 4))), num_envs)

Every wrapper is itself a batched ``Env``: state fields and
observations keep their leading ``[B]`` env axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from actor_critic_algs_on_tensorflow_tpu_torch.envs.core import (
    Box,
    Env,
    expand_as,
    tree_where,
)


class Wrapper(Env):
    def __init__(self, env: Env):
        self.env = env
        self.name = env.name

    def default_params(self):
        return self.env.default_params()

    def observation_space(self, params):
        return self.env.observation_space(params)

    def action_space(self, params):
        return self.env.action_space(params)


@dataclasses.dataclass
class FrameStackState:
    inner: Any
    frames: torch.Tensor  # [B, H, W, C * k]


class FrameStack(Wrapper):
    """Stack the last k frames along the channel axis (Atari-style)."""

    def __init__(self, env: Env, num_stack: int = 4):
        super().__init__(env)
        self.num_stack = num_stack

    def reset(self, generator, params, num_envs):
        inner, obs = self.env.reset(generator, params, num_envs)
        frames = torch.cat([obs] * self.num_stack, dim=-1)
        return FrameStackState(inner=inner, frames=frames), frames

    def step(self, generator, state, action, params):
        inner, obs, reward, done, info = self.env.step(
            generator, state.inner, action, params
        )
        c = obs.shape[-1]
        frames = torch.cat([state.frames[..., c:], obs], dim=-1)
        return FrameStackState(inner, frames), frames, reward, done, info

    def observation_space(self, params):
        sp = self.env.observation_space(params)
        shape = sp.shape[:-1] + (sp.shape[-1] * self.num_stack,)
        return Box(sp.low, sp.high, shape, sp.dtype)


class AutoReset(Wrapper):
    """Reset the wrapped env where done; the obs at the done step is the
    new episode's first observation (gymnax/envpool convention). A reset
    is drawn for every env at every step and kept where done, as in the
    JAX reference."""

    def reset(self, generator, params, num_envs):
        return self.env.reset(generator, params, num_envs)

    def step(self, generator, state, action, params):
        next_state, obs, reward, done, info = self.env.step(
            generator, state, action, params
        )
        reset_state, reset_obs = self.env.reset(generator, params, done.shape[0])
        is_done = done > 0.5
        state_out = tree_where(is_done, reset_state, next_state)
        obs_out = torch.where(expand_as(is_done, obs), reset_obs, obs)
        # The true (pre-reset) next observation: at termination the
        # terminal obs, at truncation the obs a value fn may bootstrap
        # from (time-limit bootstrapping; see ops.gae).
        info = dict(info)
        info["final_obs"] = obs
        return state_out, obs_out, reward, done, info


@dataclasses.dataclass
class EpisodeStatsState:
    inner: Any
    ep_return: torch.Tensor
    ep_length: torch.Tensor
    last_return: torch.Tensor
    last_length: torch.Tensor


class EpisodeStats(Wrapper):
    """Accumulate per-episode return/length past an AutoReset boundary.

    Adds to ``info``: ``episode_return`` / ``episode_length`` (valid
    where ``done_episode`` is 1). Place OUTSIDE AutoReset.
    """

    def reset(self, generator, params, num_envs):
        inner, obs = self.env.reset(generator, params, num_envs)
        z = torch.zeros(num_envs, device=obs.device)
        return EpisodeStatsState(inner, z, z.clone(), z.clone(), z.clone()), obs

    def step(self, generator, state, action, params):
        inner, obs, reward, done, info = self.env.step(
            generator, state.inner, action, params
        )
        ep_return = state.ep_return + reward
        ep_length = state.ep_length + 1.0
        finished = done > 0.5
        new_state = EpisodeStatsState(
            inner=inner,
            ep_return=torch.where(finished, 0.0, ep_return),
            ep_length=torch.where(finished, 0.0, ep_length),
            last_return=torch.where(finished, ep_return, state.last_return),
            last_length=torch.where(finished, ep_length, state.last_length),
        )
        info = dict(info)
        info["episode_return"] = ep_return
        info["episode_length"] = ep_length
        info["done_episode"] = done
        return new_state, obs, reward, done, info


class VecEnv(Wrapper):
    """The vectorized front: fixes the env count.

    The wrapped stack is batched already, so this only passes
    ``num_envs`` to ``reset``; state and obs carry a leading
    ``[num_envs]`` axis.
    """

    def __init__(self, env: Env, num_envs: int):
        super().__init__(env)
        self.num_envs = num_envs

    def reset(self, generator, params):
        return self.env.reset(generator, params, self.num_envs)

    def step(self, generator, state, action, params):
        return self.env.step(generator, state, action, params)
