"""train.py-style CLI of the PyTorch port.

    python -m actor_critic_algs_on_tensorflow_tpu_torch.cli.train --preset ppo-pong
    python -m actor_critic_algs_on_tensorflow_tpu_torch.cli.train --algo ppo \\
        --env CartPole-v1 --total-steps 100000 --device cpu

``--set key=value`` overrides any config field with the JAX CLI's
coercion rules, so overrides carry over verbatim. The port runs on
``cuda`` unless ``--device cpu`` is given. Ported so far: PPO and the
``ppo-pong`` preset; every other algorithm and preset of the JAX CLI
fails with "not yet ported".
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Tuple

# The JAX CLI's large-batch Atari schedule (its cli/train.py), as the
# ppo-pong preset uses it.
_PPO_ATARI_SCHEDULE = {
    "num_envs": 1024,
    "rollout_length": 128,
    "torso": "nature_cnn",
    "frame_stack": 4,
    "total_env_steps": 25_000_000,
    "lr": 2e-3,
    "lr_decay": False,
    "num_epochs": 2,
    "time_limit_bootstrap": False,
    "compute_dtype": "bfloat16",
}

PRESETS = {
    # PPO on Atari-class Pong: Nature-CNN over stacked 84x84 frames,
    # 1024 on-device envs, bf16 torso, whole-batch epochs at lr 8e-3.
    "ppo-pong": (
        "ppo",
        {
            "env": "PongTPU-v0",
            **_PPO_ATARI_SCHEDULE,
            "num_minibatches": 1,
            "lr": 8e-3,
        },
    ),
}

# Names the JAX CLI accepts that the port does not run yet.
_UNPORTED_PRESETS = (
    "a2c-cartpole", "ddpg-halfcheetah", "td3-halfcheetah", "sac-humanoid",
    "impala-cartpole", "ppo-breakout", "impala-pong", "sac-reacher",
    "a3c-cartpole", "ppo-masked-cartpole", "ppo-flicker-pong", "ppo-pendulum",
)
_ALGOS = ("a2c", "ppo", "ddpg", "td3", "sac", "impala")


def apply_overrides(cfg, overrides: list[str]):
    """Apply ``key=value`` strings; errors become argparse-style exits."""
    from actor_critic_algs_on_tensorflow_tpu_torch.utils.config import (
        apply_overrides as _apply,
    )

    try:
        return _apply(cfg, tuple(overrides))
    except KeyError as e:
        raise SystemExit(f"unknown config field: {e.args[0]}")
    except ValueError as e:
        raise SystemExit(f"--set error: {e}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="actor_critic_algs_on_tensorflow_tpu_torch.cli.train",
        description="actor-critic training entry points, PyTorch/CUDA port",
    )
    p.add_argument("--preset", help="named baseline config (ported: ppo-pong)")
    p.add_argument("--algo", choices=_ALGOS)
    p.add_argument("--env", help="env id (ported: CartPole-v1, PongTPU-v0)")
    p.add_argument("--total-steps", type=int, help="total env steps")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="override any config field (repeatable)",
    )
    p.add_argument("--log-interval", type=int, default=20)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def make_config(args) -> Tuple[str, Any]:
    from actor_critic_algs_on_tensorflow_tpu_torch.algos.ppo import PPOConfig

    if args.preset:
        if args.preset in _UNPORTED_PRESETS:
            raise SystemExit(
                f"preset {args.preset!r} is not yet ported to the PyTorch "
                f"package (ported: {sorted(PRESETS)})"
            )
        if args.preset not in PRESETS:
            raise SystemExit(
                f"unknown preset {args.preset!r} (ported: {sorted(PRESETS)})"
            )
        algo, base = PRESETS[args.preset]
        cfg = PPOConfig(**base)
    elif args.algo:
        algo = args.algo
        if algo != "ppo":
            raise SystemExit(
                f"algo {algo!r} is not yet ported to the PyTorch package "
                "(ported: ppo)"
            )
        cfg = PPOConfig()
    else:
        raise SystemExit("pass --preset or --algo (see --help)")
    if args.env:
        cfg = dataclasses.replace(cfg, env=args.env)
    if args.total_steps:
        cfg = dataclasses.replace(cfg, total_env_steps=args.total_steps)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    cfg = apply_overrides(cfg, args.set)
    return algo, cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    algo, cfg = make_config(args)
    print(f"[train] algo={algo} device={args.device} config={cfg}", flush=True)

    from actor_critic_algs_on_tensorflow_tpu_torch.algos import common
    from actor_critic_algs_on_tensorflow_tpu_torch.algos.ppo import make_ppo

    fns = make_ppo(cfg, device=args.device)
    _, history = common.run_loop(
        fns,
        total_env_steps=cfg.total_env_steps,
        seed=cfg.seed,
        log_interval_iters=args.log_interval,
    )
    if history:
        final = history[-1][1]
        print(
            f"[train] done: env_steps={history[-1][0]} "
            f"steps_per_sec={final.get('steps_per_sec', 0):.0f} "
            f"avg_return={final.get('avg_return', float('nan')):.2f}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
