"""PPO: clipped-surrogate proximal policy optimization.

Counterpart of the feed-forward iteration of the JAX package's
``algos/ppo.py``: rollout, GAE (through the CUDA scan kernel on the
card), then ``num_epochs`` epochs of whole-batch, ``shuffle="full"``
or ``shuffle="env"`` minibatch, or ``grad_accum`` updates, with the
gradient clipped by global norm and applied by Adam.

Not yet ported, and refused with an error: ``recurrent``,
``compact_frames``, ``normalize_obs`` and ``num_devices > 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from actor_critic_algs_on_tensorflow_tpu_torch import envs as envs_lib
from actor_critic_algs_on_tensorflow_tpu_torch.algos import common
from actor_critic_algs_on_tensorflow_tpu_torch.data.rollout import (
    env_block_starts,
    flatten_time_batch,
    minibatch_iter_indices,
    take_minibatch,
)
from actor_critic_algs_on_tensorflow_tpu_torch.ops import (
    clipped_value_loss,
    gae_advantages,
    ppo_clip_loss,
    value_loss,
)
from actor_critic_algs_on_tensorflow_tpu_torch.utils import prng

# prng.fold purposes
_ENV_RESET, _MODEL_INIT, _ITERATION = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    env: str = "CartPole-v1"
    num_envs: int = 8
    rollout_length: int = 128
    total_env_steps: int = 500_000
    frame_stack: int = 0
    torso: str = "mlp"              # "mlp" | "nature_cnn"
    hidden_sizes: Tuple[int, ...] = (64, 64)
    lr: float = 2.5e-4
    lr_decay: bool = True
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_clip: bool = True
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    num_epochs: int = 4
    num_minibatches: int = 4
    # Minibatch composition for num_minibatches > 1:
    #   "full" — a random permutation of the flattened [T*B] batch each
    #            epoch;
    #   "env"  — each minibatch is all rollout steps of a contiguous
    #            block of envs; only the block visit order is drawn.
    shuffle: str = "full"
    # Whole-batch epochs only: accumulate the epoch gradient over this
    # many contiguous slices of the flattened batch (advantages are
    # whitened over the full batch first), then take one step.
    grad_accum: int = 1
    normalize_adv: bool = True
    recurrent: bool = False         # not yet ported
    normalize_obs: bool = False     # not yet ported
    time_limit_bootstrap: bool = True
    compact_frames: bool = False    # not yet ported
    compute_dtype: str = "float32"  # "bfloat16" runs the torso in bf16
    # Kept so presets and --set overrides carry over from the JAX
    # package. It chooses nothing here: GAE always runs the CUDA scan
    # kernel on a CUDA tensor and its plain version on a CPU tensor.
    use_pallas_scan: bool = False
    numerics_guards: bool = True
    seed: int = 0
    num_devices: int = 0            # 0 = all visible devices; only 1 is ported


def _check_config(cfg: PPOConfig) -> None:
    unported = [
        name for name, on in (
            ("recurrent", cfg.recurrent),
            ("compact_frames", cfg.compact_frames),
            ("normalize_obs", cfg.normalize_obs),
            ("num_devices > 1", cfg.num_devices > 1),
        ) if on
    ]
    if unported:
        raise NotImplementedError(
            f"PPO option(s) {', '.join(unported)} not yet ported to the "
            "PyTorch package"
        )
    local_batch = cfg.num_envs * cfg.rollout_length
    if local_batch % cfg.num_minibatches:
        raise ValueError(
            f"batch {local_batch} not divisible by "
            f"{cfg.num_minibatches} minibatches"
        )
    if cfg.shuffle not in ("full", "env"):
        raise ValueError(f"shuffle must be 'full' or 'env', got {cfg.shuffle!r}")
    if (
        cfg.shuffle == "env"
        and cfg.num_minibatches > 1
        and cfg.num_envs % cfg.num_minibatches
    ):
        raise ValueError(
            f"shuffle='env' slices the env axis: {cfg.num_envs} envs "
            f"not divisible by {cfg.num_minibatches} minibatches"
        )
    if cfg.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {cfg.grad_accum}")
    if cfg.grad_accum > 1:
        if cfg.num_minibatches != 1:
            raise ValueError(
                "grad_accum accumulates whole-batch epochs; it requires "
                f"num_minibatches=1 (got {cfg.num_minibatches})"
            )
        if local_batch % cfg.grad_accum:
            raise ValueError(
                f"batch {local_batch} not divisible by "
                f"grad_accum={cfg.grad_accum}"
            )


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with eps outside the square root and bias correction, as
    ``optax.adam(eps=1e-5)``."""
    return torch.optim.Adam(model.parameters(), lr=lr, eps=1e-5)


def learning_rate(cfg: PPOConfig, updates: int, num_updates: int) -> float:
    """``optax.linear_schedule(lr, 0, num_updates)`` at optimizer step
    ``updates``, or the constant ``lr``."""
    if not cfg.lr_decay:
        return cfg.lr
    frac = min(updates, num_updates) / num_updates
    return cfg.lr + (0.0 - cfg.lr) * frac


def clip_grads_by_global_norm_(params: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: scale every gradient by
    ``max_norm / ||g||`` only where ``||g|| >= max_norm``, in place.
    (``torch.nn.utils.clip_grad_norm_`` divides by ``||g|| + 1e-6``.)
    Returns the global norm, without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def ppo_loss(model, dist_and_value, mb: Dict[str, torch.Tensor], adv, cfg: PPOConfig):
    """PPO loss on minibatch ``mb`` with advantages ``adv`` (whitening is
    the caller's job). Returns ``(total, metrics)``."""
    dist, values = dist_and_value(model, mb["obs"])
    stats = ppo_clip_loss(
        dist.log_prob(mb["actions"]), mb["old_log_probs"], adv,
        clip_eps=cfg.clip_eps,
    )
    if cfg.vf_clip:
        vf = clipped_value_loss(
            values, mb["old_values"], mb["returns"], clip_eps=cfg.clip_eps
        )
    else:
        vf = value_loss(values, mb["returns"])
    ent = dist.entropy().mean()
    total = stats.policy_loss + cfg.vf_coef * vf - cfg.ent_coef * ent
    metrics = {
        "loss": total.detach(),
        "policy_loss": stats.policy_loss.detach(),
        "value_loss": vf.detach(),
        "entropy": ent.detach(),
        "clip_fraction": stats.clip_fraction,
        "approx_kl": stats.approx_kl,
    }
    return total, metrics


def apply_grads(model, optimizer, cfg: PPOConfig, lr: float) -> None:
    """Clip by global norm, then one Adam step at ``lr``."""
    clip_grads_by_global_norm_(list(model.parameters()), cfg.max_grad_norm)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


def minibatch_update(model, optimizer, dist_and_value, mb, cfg: PPOConfig, lr: float):
    """One optimizer step on ``mb``, advantages whitened over ``mb``."""
    adv = mb["advantages"]
    if cfg.normalize_adv:
        adv = common.global_normalize_advantages(adv)
    optimizer.zero_grad(set_to_none=True)
    total, m = ppo_loss(model, dist_and_value, mb, adv, cfg)
    total.backward()
    apply_grads(model, optimizer, cfg, lr)
    return m


def accum_epoch_update(model, optimizer, dist_and_value, batch, cfg: PPOConfig, lr: float):
    """Whole-batch epoch as ``grad_accum`` contiguous slices: advantages
    whitened over the full batch first, slice gradients averaged, one
    optimizer step. The mean of equal-size slice gradients is the
    whole-batch gradient; peak activation memory shrinks by the
    accumulation factor."""
    adv = batch["advantages"]
    if cfg.normalize_adv:
        adv = common.global_normalize_advantages(adv)
    n_acc = cfg.grad_accum
    optimizer.zero_grad(set_to_none=True)
    ms = []
    for i in range(n_acc):
        mb = {k: v.chunk(n_acc)[i] for k, v in batch.items()}
        total, m = ppo_loss(model, dist_and_value, mb, adv.chunk(n_acc)[i], cfg)
        (total / n_acc).backward()
        ms.append(m)
    apply_grads(model, optimizer, cfg, lr)
    return {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}


def make_ppo(cfg: PPOConfig, device: str | torch.device = "cuda") -> common.IterationFns:
    """Build ``init`` and ``iteration`` for PPO on ``device``.

    ``device`` is ``cuda`` unless the caller asks for ``cpu``.
    """
    _check_config(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_ppo(device='cuda') needs a CUDA card; pass device='cpu' "
            "to run on the CPU"
        )
    env, env_params = envs_lib.make(
        cfg.env, num_envs=cfg.num_envs, frame_stack=cfg.frame_stack
    )
    action_space = env.action_space(env_params)
    obs_shape = env.observation_space(env_params).shape
    env_sliced = cfg.shuffle == "env" and cfg.num_minibatches > 1
    batch_size = cfg.num_envs * cfg.rollout_length
    mb_envs = cfg.num_envs // cfg.num_minibatches
    num_iters = max(1, cfg.total_env_steps // batch_size)
    num_updates = num_iters * cfg.num_epochs * cfg.num_minibatches

    dist_and_value = common.policy_dist_and_value(action_space)

    def policy_fn(model, obs, generator):
        dist, value = dist_and_value(model, obs)
        action = dist.sample(generator)
        return action, dist.log_prob(action), value

    def init(seed: int) -> common.OnPolicyState:
        env_gen = prng.generator(prng.fold(seed, _ENV_RESET), device)
        env_state, obs = env.reset(env_gen, env_params)
        # Weights are drawn on the CPU, so a seed gives one model on
        # every device.
        model, _ = common.make_policy_head(
            action_space, obs_shape,
            torso=cfg.torso,
            hidden_sizes=cfg.hidden_sizes,
            compute_dtype=cfg.compute_dtype,
            generator=prng.generator(prng.fold(seed, _MODEL_INIT)),
        )
        model = model.to(device)
        return common.OnPolicyState(
            model=model,
            optimizer=make_optimizer(model, cfg.lr),
            env_state=env_state,
            obs=obs,
            seed=seed,
        )

    def iteration(state: common.OnPolicyState, mark: common.PhaseMark | None = None):
        mark = mark or (lambda phase: None)
        gen = prng.generator(prng.fold(state.seed, _ITERATION, state.step), device)
        model, optimizer = state.model, state.optimizer

        env_state, obs, traj, ep_info = common.collect_rollout(
            env, env_params, policy_fn, model, state.env_state, state.obs,
            gen, cfg.rollout_length, keep_final_obs=cfg.time_limit_bootstrap,
        )
        with torch.no_grad():
            _, last_value = dist_and_value(model, obs)
            truncation_values = None
            if cfg.time_limit_bootstrap:
                _, truncation_values = dist_and_value(model, ep_info["final_obs"])
        mark("rollout")
        advantages, returns = gae_advantages(
            traj.rewards, traj.values, traj.dones, last_value,
            gamma=cfg.gamma, lam=cfg.gae_lambda,
            terminations=ep_info["terminated"],
            truncation_values=truncation_values,
            use_pallas=cfg.use_pallas_scan,
        )
        mark("gae")

        env_tb = {
            "actions": traj.actions,
            "old_log_probs": traj.log_probs,
            "old_values": traj.values,
            "advantages": advantages,
            "returns": returns,
        }
        batch = flatten_time_batch(env_tb)
        batch["obs"] = traj.obs.reshape((batch_size,) + tuple(traj.obs.shape[2:]))
        updates = state.updates
        ms = []
        for _ in range(cfg.num_epochs):
            if cfg.num_minibatches == 1:
                lr = learning_rate(cfg, updates, num_updates)
                if cfg.grad_accum > 1:
                    ms.append(accum_epoch_update(
                        model, optimizer, dist_and_value, batch, cfg, lr))
                else:
                    ms.append(minibatch_update(
                        model, optimizer, dist_and_value, batch, cfg, lr))
                updates += 1
                continue
            if env_sliced:
                starts = env_block_starts(gen, cfg.num_minibatches, mb_envs)
                blocks = []
                for start in starts.tolist():
                    mb = {
                        k: v[:, start:start + mb_envs].reshape(
                            (-1,) + tuple(v.shape[2:]))
                        for k, v in dict(env_tb, obs=traj.obs).items()
                    }
                    blocks.append(mb)
            else:
                idx = minibatch_iter_indices(gen, batch_size, cfg.num_minibatches)
                blocks = (take_minibatch(batch, i) for i in idx)
            for mb in blocks:
                lr = learning_rate(cfg, updates, num_updates)
                ms.append(minibatch_update(
                    model, optimizer, dist_and_value, mb, cfg, lr))
                updates += 1
        # Mean over epochs x minibatches.
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        # Guard BEFORE the mean dilutes anything: any non-finite
        # minibatch loss, or a non-finite updated parameter.
        metrics.update(common.guard_metrics(
            cfg.numerics_guards,
            (torch.stack([m["loss"] for m in ms]), model),
        ))
        metrics.update(common.episode_metrics(ep_info))
        mark("update")
        new_state = dataclasses.replace(
            state, env_state=env_state, obs=obs,
            step=state.step + 1, updates=updates,
        )
        return new_state, metrics

    return common.IterationFns(
        init=init,
        iteration=iteration,
        device=device,
        steps_per_iteration=batch_size,
    )
