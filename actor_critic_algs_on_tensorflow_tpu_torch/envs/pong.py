"""PongTPU: an Atari-Pong-class environment, batched on the device.

Counterpart of ``PongTPU`` in the JAX package's ``envs/pong.py``: two
paddles, a bouncing ball, first to 21, +-1 point rewards, 6 Atari-style
actions, 84x84 grayscale uint8 frames rendered on the device. One env
step is one observed frame (post-frameskip). The agent controls the
RIGHT paddle; the scripted opponent (capped tracking speed, recenters
when the ball moves away) controls the left.

Every step is a few dozen elementwise ops over the ``[B]`` env axis,
and all ``B`` frames are rendered at once as one ``[B, 84, 84]``
broadcast comparison.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from actor_critic_algs_on_tensorflow_tpu_torch.envs.core import Box, Discrete, Env


@dataclasses.dataclass(frozen=True)
class PongParams:
    ball_speed: float = 1.5
    max_ball_vy: float = 2.0
    paddle_speed: float = 2.0
    opp_speed: float = 1.0
    spin: float = 0.25          # vy added per pixel of paddle-hit offset
    speedup: float = 1.03       # |vx| multiplier per paddle hit
    max_ball_vx: float = 3.0
    win_score: int = 21
    height: int = 84
    width: int = 84
    paddle_half: int = 4
    max_steps: int = 10_000


@dataclasses.dataclass
class PongState:
    ball_x: torch.Tensor        # [B] float32
    ball_y: torch.Tensor
    ball_vx: torch.Tensor
    ball_vy: torch.Tensor
    agent_y: torch.Tensor
    opp_y: torch.Tensor
    agent_score: torch.Tensor   # [B] int32
    opp_score: torch.Tensor
    t: torch.Tensor


# Atari Pong action set: NOOP, FIRE, RIGHT(=up), LEFT(=down), RIGHTFIRE,
# LEFTFIRE -> paddle direction {0, 0, -1, +1, -1, +1}.
_ACTION_DIRS = (0.0, 0.0, -1.0, 1.0, -1.0, 1.0)


def _action_dirs(action: torch.Tensor) -> torch.Tensor:
    """``_ACTION_DIRS[action]`` as arithmetic on the device (no host
    table to copy each step): 0 for actions 0-1, else -1 for even and
    +1 for odd actions."""
    a = action.long()
    return torch.where(a < 2, 0.0, (a % 2).float() * 2.0 - 1.0)


class PongTPU(Env[PongState, PongParams]):
    name = "PongTPU-v0"

    def default_params(self) -> PongParams:
        return PongParams()

    def _serve(self, generator, params, direction):
        """Ball at center, heading ``direction`` (+1 toward agent).

        Draws ``vy`` then ``y`` for every env in ``direction``'s batch.
        """
        n = direction.shape[0]
        u = torch.rand((2, n), generator=generator, device=generator.device)
        vy = u[0] * 2.0 - 1.0
        y = params.height * 0.25 + u[1] * (params.height * 0.5)
        return (
            torch.full_like(vy, params.width / 2.0),
            y,
            direction * params.ball_speed,
            vy,
        )

    def reset(self, generator, params, num_envs):
        dev = generator.device
        heads = torch.rand(num_envs, generator=generator, device=dev) < 0.5
        direction = torch.where(heads, 1.0, -1.0).to(dev)
        bx, by, vx, vy = self._serve(generator, params, direction)
        mid = torch.full((num_envs,), params.height / 2.0, device=dev)
        zeros = torch.zeros(num_envs, dtype=torch.int32, device=dev)
        state = PongState(
            ball_x=bx,
            ball_y=by,
            ball_vx=vx,
            ball_vy=vy,
            agent_y=mid,
            opp_y=mid.clone(),
            agent_score=zeros,
            opp_score=zeros.clone(),
            t=zeros.clone(),
        )
        return state, self._obs(state, params)

    def step(self, generator, state, action, params):
        ph = float(params.paddle_half)
        h, w = float(params.height), float(params.width)
        # --- paddles ---------------------------------------------------
        dy = _action_dirs(action) * params.paddle_speed
        agent_y = (state.agent_y + dy).clamp(ph, h - 1.0 - ph)
        # Opponent tracks the ball while it approaches, else recenters.
        approaching = state.ball_vx < 0.0
        opp_target = torch.where(approaching, state.ball_y, h / 2.0)
        opp_dy = (opp_target - state.opp_y).clamp(
            -params.opp_speed, params.opp_speed
        )
        opp_y = (state.opp_y + opp_dy).clamp(ph, h - 1.0 - ph)

        # --- ball flight ----------------------------------------------
        bx = state.ball_x + state.ball_vx
        by = state.ball_y + state.ball_vy
        vx = state.ball_vx
        vy = state.ball_vy
        # bounce off top/bottom walls (the top test reads the OLD state)
        by = torch.where(by < 0.0, -by, by)
        vy = torch.where(state.ball_y + state.ball_vy < 0.0, -vy, vy)
        over = by > (h - 1.0)
        by = torch.where(over, 2.0 * (h - 1.0) - by, by)
        vy = torch.where(over, -vy.abs(), vy)

        # --- paddle collisions ----------------------------------------
        agent_col = w - 3.0
        opp_col = 2.0
        hit_agent = (bx >= agent_col) & (vx > 0.0) & (
            (by - agent_y).abs() <= ph + 1.0
        )
        hit_opp = (bx <= opp_col) & (vx < 0.0) & ((by - opp_y).abs() <= ph + 1.0)
        new_speed = (vx.abs() * params.speedup).clamp(
            0.0, params.max_ball_vx
        )
        vx = torch.where(hit_agent, -new_speed, vx)
        vx = torch.where(hit_opp, new_speed, vx)
        vy = torch.where(
            hit_agent,
            (vy + (by - agent_y) * params.spin).clamp(
                -params.max_ball_vy, params.max_ball_vy
            ),
            vy,
        )
        vy = torch.where(
            hit_opp,
            (vy + (by - opp_y) * params.spin).clamp(
                -params.max_ball_vy, params.max_ball_vy
            ),
            vy,
        )
        bx = torch.where(hit_agent, agent_col - 1.0, bx)
        bx = torch.where(hit_opp, opp_col + 1.0, bx)

        # --- scoring ---------------------------------------------------
        agent_missed = bx > (w - 1.0)
        opp_missed = bx < 0.0
        reward = torch.where(agent_missed, -1.0, opp_missed.float())
        agent_score = state.agent_score + opp_missed.int()
        opp_score = state.opp_score + agent_missed.int()

        # A serve is drawn for every env at every step and kept only
        # where a point was scored, as in the JAX reference.
        scored = agent_missed | opp_missed
        serve_dir = torch.where(agent_missed, -1.0, 1.0)
        sx, sy, svx, svy = self._serve(generator, params, serve_dir)
        bx = torch.where(scored, sx, bx)
        by = torch.where(scored, sy, by)
        vx = torch.where(scored, svx, vx)
        vy = torch.where(scored, svy, vy)

        t = state.t + 1
        new_state = PongState(
            ball_x=bx,
            ball_y=by,
            ball_vx=vx,
            ball_vy=vy,
            agent_y=agent_y,
            opp_y=opp_y,
            agent_score=agent_score,
            opp_score=opp_score,
            t=t,
        )
        terminated = (
            (agent_score >= params.win_score) | (opp_score >= params.win_score)
        ).float()
        truncated = (t >= params.max_steps).float()
        done = torch.maximum(terminated, truncated)
        info: Dict[str, torch.Tensor] = {
            "terminated": terminated,
            "truncated": truncated,
        }
        return new_state, self._obs(new_state, params), reward, done, info

    def _obs(self, state: PongState, params: PongParams) -> torch.Tensor:
        """Render ``[B, H, W, 1]`` uint8 frames with broadcast comparisons."""
        dev = state.ball_x.device
        rows = torch.arange(params.height, dtype=torch.float32, device=dev)[:, None]
        cols = torch.arange(params.width, dtype=torch.float32, device=dev)[None, :]
        ph = float(params.paddle_half)
        w = float(params.width)

        def col_rows(y):  # [B, H, 1]: rows within one paddle half of y
            return (rows - y[:, None, None]).abs() <= ph

        agent_mask = ((cols >= w - 3.0) & (cols <= w - 2.0)) & col_rows(state.agent_y)
        opp_mask = ((cols >= 1.0) & (cols <= 2.0)) & col_rows(state.opp_y)
        ball_mask = ((cols - state.ball_x[:, None, None]).abs() <= 1.0) & (
            (rows - state.ball_y[:, None, None]).abs() <= 1.0
        )
        frame = (agent_mask | opp_mask | ball_mask).to(torch.uint8) * 255
        return frame[..., None]

    def observation_space(self, params):
        return Box(0, 255, (params.height, params.width, 1), torch.uint8)

    def action_space(self, params):
        return Discrete(6)
