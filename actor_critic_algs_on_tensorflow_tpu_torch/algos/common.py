"""Shared on-policy training machinery.

Counterpart of the JAX package's ``algos/common.py``. One iteration is
rollout -> GAE -> update, as there; here it runs eagerly on one device:
the rollout is a Python loop over time in place of ``lax.scan``, env
batches are written out in place of ``vmap``, and the host only reads
metrics at log intervals (no host sync inside an iteration on the
main path).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from actor_critic_algs_on_tensorflow_tpu_torch.data.rollout import Trajectory
from actor_critic_algs_on_tensorflow_tpu_torch.models import DiscreteActorCritic
from actor_critic_algs_on_tensorflow_tpu_torch.ops import Categorical

# policy_fn(model, obs, generator) -> (action, log_prob, value)
PolicyFn = Callable[
    [torch.nn.Module, torch.Tensor, torch.Generator],
    Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
]

# A phase mark: called with a phase name when that phase of an
# iteration has been enqueued ("rollout", "gae", "update").
PhaseMark = Callable[[str], None]


@dataclasses.dataclass
class OnPolicyState:
    """Train state for A2C/PPO-style algorithms.

    The JAX package's ``params``/``opt_state`` pytrees are the ``model``
    (an ``nn.Module`` holding the params) and its ``optimizer`` here;
    both are updated in place. ``seed`` takes the place of the root
    key: each iteration draws from a generator folded from
    ``(seed, step)``. ``updates`` counts optimizer steps, which the
    learning-rate schedule reads.
    """

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    env_state: Any
    obs: torch.Tensor
    seed: int
    step: int = 0  # iterations; env steps = step * steps_per_iteration
    updates: int = 0


class IterationFns(NamedTuple):
    """A training program: ``init`` and one iteration.

    ``iteration(state, mark=None)`` returns ``(state, metrics)`` with
    metrics as 0-dim tensors on the device; ``mark`` is an optional
    :data:`PhaseMark`.
    """

    init: Callable[[int], OnPolicyState]
    iteration: Callable[..., Tuple[OnPolicyState, Dict[str, torch.Tensor]]]
    device: torch.device
    steps_per_iteration: int


def _categorical_dist_and_value(model, obs):
    logits, value = model(obs)
    return Categorical(logits), value


def policy_dist_and_value(action_space):
    """``dist_and_value(model, obs) -> (dist, value)`` for an action
    space: Categorical for a discrete one. The continuous
    (diagonal-Gaussian) head waits for a later slice."""
    if not hasattr(action_space, "n"):
        raise NotImplementedError(
            "continuous action spaces (GaussianActorCritic) are not yet "
            "ported to the PyTorch package"
        )
    return _categorical_dist_and_value


def make_policy_head(
    action_space, obs_shape, *, torso, hidden_sizes, compute_dtype,
    generator=None,
):
    """(model, dist_and_value) for a discrete (Categorical) action
    space; the weights are drawn from ``generator``."""
    dist_and_value = policy_dist_and_value(action_space)
    model = DiscreteActorCritic(
        obs_shape,
        action_space.n,
        torso=torso,
        hidden_sizes=hidden_sizes,
        dtype=getattr(torch, compute_dtype),
        generator=generator,
    )
    return model, dist_and_value


def collect_rollout(
    env,
    env_params,
    policy_fn: PolicyFn,
    model,
    env_state,
    obs,
    generator: torch.Generator,
    length: int,
    *,
    keep_final_obs: bool = False,
):
    """Collect a ``[T, B]`` trajectory with a loop over time.

    Returns ``(env_state, obs, trajectory, ep_info)`` where ``ep_info``
    holds per-step episode stats from the EpisodeStats wrapper plus the
    ``terminated`` mask (and, with ``keep_final_obs``, the pre-reset
    ``final_obs`` for time-limit bootstrapping). Observations are
    written into one preallocated ``[T, B, ...]`` buffer; the other
    fields are stacked at the end. Runs without autograd.
    """
    obs_buf = torch.empty((length,) + tuple(obs.shape), dtype=obs.dtype, device=obs.device)
    steps = []
    final_obs = []
    with torch.no_grad():
        for t in range(length):
            action, log_prob, value = policy_fn(model, obs, generator)
            obs_buf[t].copy_(obs)
            env_state, obs, reward, done, info = env.step(
                generator, env_state, action, env_params
            )
            steps.append(
                (action, reward, done, log_prob, value,
                 info["episode_return"], info["done_episode"], info["terminated"])
            )
            if keep_final_obs:
                final_obs.append(info["final_obs"])
    cols = [torch.stack(c) for c in zip(*steps)]
    traj = Trajectory(obs_buf, *cols[:5])
    ep_info = {
        "episode_return": cols[5],
        "done_episode": cols[6],
        "terminated": cols[7],
    }
    if keep_final_obs:
        ep_info["final_obs"] = torch.stack(final_obs)
    return env_state, obs, traj, ep_info


def guard_metrics(enabled: bool, guarded_tree) -> Dict[str, torch.Tensor]:
    """``{"health_finite": 0/1}`` when ``enabled``, else ``{}``: one
    reduction over whatever the trainer stakes its health on (losses,
    updated params). Metrics only; the params are untouched."""
    if not enabled:
        return {}
    from actor_critic_algs_on_tensorflow_tpu_torch.utils import health

    return {"health_finite": health.all_finite(guarded_tree).float()}


def global_normalize_advantages(adv: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Whiten advantages: population variance and ``rsqrt(var + eps)``,
    as the JAX package computes it (not ``torch.std``, which is
    unbiased and divides by ``std + eps``). One device, so the moments
    are the global ones."""
    mean = adv.mean()
    var = ((adv - mean) ** 2).mean()
    return (adv - mean) * torch.rsqrt(var + eps)


def episode_metrics(ep_info) -> Dict[str, torch.Tensor]:
    """Mean return over episodes finished in this rollout."""
    done = ep_info["done_episode"]
    ret_sum = (ep_info["episode_return"] * done).sum()
    n = done.sum()
    return {"episodes": n, "avg_return": ret_sum / n.clamp(min=1.0)}


class RateClock:
    """Windowed env-steps/sec accounting shared by the training loops.

    Excludes the first iteration (kernel builds, allocator warm-up)
    from every window; short tail windows fall back to the cumulative
    rate after the first iteration."""

    def __init__(self, steps_per_iteration: int, log_interval_iters: int):
        self.spi = steps_per_iteration
        self.interval = log_interval_iters
        now = time.perf_counter()
        self.t0 = now
        self.t1 = now
        self.last_it, self.last_t = 0, now

    def first_iteration_done(self) -> None:
        self.t1 = time.perf_counter()
        self.last_it, self.last_t = 1, self.t1

    def rate(self, it: int) -> float:
        """steps/sec at 0-based iteration ``it`` (just completed)."""
        now = time.perf_counter()
        window = it + 1 - self.last_it
        if window >= max(self.interval - 1, 1):
            r = window * self.spi / max(now - self.last_t, 1e-9)
        elif it >= 1:
            r = it * self.spi / max(now - self.t1, 1e-9)
        else:
            r = self.spi / max(now - self.t0, 1e-9)
        self.last_it, self.last_t = it + 1, now
        return r


def run_loop(
    fns: IterationFns,
    *,
    total_env_steps: int,
    seed: int = 0,
    log_interval_iters: int = 20,
    log_fn: Callable[[int, Dict[str, float]], None] | None = None,
    state: OnPolicyState | None = None,
    mark: PhaseMark | None = None,
):
    """Host-side training loop: run iterations, surface metrics.

    Returns ``(final_state, history)`` where ``history`` is a list of
    (env_steps, metrics-dict) tuples fetched at log intervals. Episode
    stats are aggregated over the whole log window on the device and
    fetched only at log time. ``mark`` is passed to every iteration.
    Checkpointing, the health sentinel and summary writers wait for a
    later slice.
    """
    from actor_critic_algs_on_tensorflow_tpu_torch.utils.metrics import (
        fetch_metrics,
        format_metrics,
    )

    if state is None:
        state = fns.init(seed)
    iters_done0 = state.step
    steps_done0 = iters_done0 * fns.steps_per_iteration
    num_iters = (total_env_steps - steps_done0) // fns.steps_per_iteration
    if iters_done0 == 0:
        num_iters = max(1, num_iters)
    if num_iters <= 0:
        return state, []
    history = []
    clock = RateClock(fns.steps_per_iteration, log_interval_iters)
    ep_count = ret_sum = None
    for it in range(num_iters):
        state, metrics = fns.iteration(state, mark)
        n = metrics["episodes"]
        r = metrics["avg_return"] * n
        if ep_count is None:
            ep_count, ret_sum = n, r
        else:
            ep_count, ret_sum = ep_count + n, ret_sum + r
        if it == 0:
            if fns.device.type == "cuda":
                torch.cuda.synchronize(fns.device)
            clock.first_iteration_done()
        if (it + 1) % log_interval_iters == 0 or it == num_iters - 1:
            fetch = dict(metrics)
            fetch["episodes"] = ep_count
            fetch["_window_return_sum"] = ret_sum
            m = fetch_metrics(fetch)
            rs = m.pop("_window_return_sum")
            m["avg_return"] = rs / m["episodes"] if m["episodes"] else 0.0
            ep_count = ret_sum = None
            env_steps = steps_done0 + (it + 1) * fns.steps_per_iteration
            m["steps_per_sec"] = clock.rate(it)
            history.append((env_steps, m))
            if log_fn is not None:
                log_fn(env_steps, m)
            else:
                print(format_metrics(env_steps, m), flush=True)
    return state, history
