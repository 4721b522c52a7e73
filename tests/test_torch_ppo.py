"""The port's PPO against the JAX package's, and the slice end to end.

The update half is held exactly: Flax params transplanted into the
port's model, one fixed numpy batch, and whole-batch PPO epochs (GAE,
advantage whitening, clipped losses, clip by global norm, Adam) on both
sides. The JAX side is composed here from the JAX package's own
functions as its ``algos/ppo.py`` composes them. Updated params must
agree at float32 precision, atol 1e-5. The Nature-CNN is held over one
epoch: from the second on, a ReLU whose input lies within rounding of
zero may switch on one side only, and Adam's second step amplifies the
changed gradient of a weight whose gradient is near zero up to the
learning rate. The tanh MLP is smooth and is held over two epochs.

The slice runs end to end on the CPU at a tiny size; randomness makes
it comparable to JAX only in distribution, so it is held to finite
metrics, the health guard and determinism for a seed.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from actor_critic_algs_on_tensorflow_tpu import ops as jops
from actor_critic_algs_on_tensorflow_tpu.algos import common as jcommon
from actor_critic_algs_on_tensorflow_tpu.models import networks as jnets
from actor_critic_algs_on_tensorflow_tpu_torch import ops as tops
from actor_critic_algs_on_tensorflow_tpu_torch.algos import common as tcommon
from actor_critic_algs_on_tensorflow_tpu_torch.algos import ppo as tppo
from actor_critic_algs_on_tensorflow_tpu_torch.cli import train as tcli
from actor_critic_algs_on_tensorflow_tpu_torch.envs import Discrete
from actor_critic_algs_on_tensorflow_tpu_torch.models import networks as tnets
from actor_critic_algs_on_tensorflow_tpu_torch.utils.transplant import from_flax

torch.set_num_threads(1)

# torso -> (obs shape, actions, T, B)
_SHAPES = {"nature_cnn": ((84, 84, 4), 6, 4, 3), "mlp": ((4,), 2, 8, 4)}


def _batch(torso, seed=0):
    obs_shape, n_act, t, b = _SHAPES[torso]
    rng = np.random.default_rng(seed)
    if torso == "nature_cnn":
        obs = ((rng.random((t, b) + obs_shape) < 0.05) * 255).astype(np.uint8)
    else:
        obs = rng.normal(size=(t, b) + obs_shape).astype(np.float32)
    return {
        "obs": obs,
        "actions": rng.integers(0, n_act, (t, b)),
        "old_log_probs": (math.log(1.0 / n_act)
                          + 0.1 * rng.normal(size=(t, b))).astype(np.float32),
        "old_values": rng.normal(size=(t, b)).astype(np.float32),
        "rewards": rng.normal(size=(t, b)).astype(np.float32),
        "dones": (rng.random((t, b)) < 0.2).astype(np.float32),
        "last_value": rng.normal(size=b).astype(np.float32),
    }


def _jax_epochs(cfg, jmodel, params, d, epochs):
    """Whole-batch epochs composed as the JAX package's ppo.py does."""
    tx = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adam(cfg.lr, eps=1e-5),
    )
    opt_state = tx.init(params)
    adv, ret = jops.gae_advantages(
        jnp.asarray(d["rewards"]), jnp.asarray(d["old_values"]),
        jnp.asarray(d["dones"]), jnp.asarray(d["last_value"]),
        gamma=cfg.gamma, lam=cfg.gae_lambda,
    )
    flat = lambda x: jnp.asarray(x).reshape((-1,) + jnp.asarray(x).shape[2:])
    obs, actions = flat(d["obs"]), flat(d["actions"])
    old_lp, old_v = flat(d["old_log_probs"]), flat(d["old_values"])
    adv, ret = flat(adv), flat(ret)

    def loss_fn(p):
        logits, values = jmodel.apply(p, obs)
        dist = jops.Categorical(logits)
        a = jcommon.global_normalize_advantages(adv, axis_name=None)
        stats = jops.ppo_clip_loss(dist.log_prob(actions), old_lp, a,
                                   clip_eps=cfg.clip_eps)
        vf = jops.clipped_value_loss(values, old_v, ret, clip_eps=cfg.clip_eps)
        return stats.policy_loss + cfg.vf_coef * vf - cfg.ent_coef * dist.entropy().mean()

    loss_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for _ in range(epochs):
        loss, grads = loss_and_grad(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return params, losses


def _torch_epochs(cfg, tmodel, d, epochs):
    """The port's own update path: gae_advantages, then
    ``ppo.minibatch_update`` on the whole batch per epoch."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    adv, ret = tops.gae_advantages(
        t["rewards"], t["old_values"], t["dones"], t["last_value"],
        gamma=cfg.gamma, lam=cfg.gae_lambda,
    )
    obs_shape, n_act, _, _ = _SHAPES[cfg.torso]
    dist_and_value = tcommon.policy_dist_and_value(Discrete(n_act))
    batch = {
        "obs": t["obs"].reshape((-1,) + obs_shape),
        "actions": t["actions"].reshape(-1),
        "old_log_probs": t["old_log_probs"].reshape(-1),
        "old_values": t["old_values"].reshape(-1),
        "advantages": adv.reshape(-1),
        "returns": ret.reshape(-1),
    }
    opt = tppo.make_optimizer(tmodel, cfg.lr)
    losses = []
    for _ in range(epochs):
        m = tppo.minibatch_update(tmodel, opt, dist_and_value, batch, cfg, cfg.lr)
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("torso,epochs", [("nature_cnn", 1), ("mlp", 2)])
@pytest.mark.parametrize("max_grad_norm", [0.5, 100.0])  # clip on / off
def test_update_half_matches_jax(torso, epochs, max_grad_norm):
    obs_shape, n_act, _, _ = _SHAPES[torso]
    cfg = tppo.PPOConfig(torso=torso, lr=1e-3, max_grad_norm=max_grad_norm,
                         lr_decay=False)
    d = _batch(torso)
    jmodel = jnets.DiscreteActorCritic(num_actions=n_act, torso=torso)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(d["obs"][0, :1]))
    tmodel = tnets.DiscreteActorCritic(obs_shape, n_act, torso=torso)
    tmodel.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params)))

    jparams, jlosses = _jax_epochs(cfg, jmodel, params, d, epochs)
    tlosses = _torch_epochs(cfg, tmodel, d, epochs)

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-6)
    want = from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    got = tmodel.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for max_norm in (0.5, 1e3):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        tppo.clip_grads_by_global_norm_(params, max_norm)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_linear_schedule_matches_optax():
    cfg = tppo.PPOConfig(lr=2.5e-4, lr_decay=True)
    sched = optax.linear_schedule(cfg.lr, 0.0, 40)
    for count in (0, 1, 17, 39, 40, 55):
        assert tppo.learning_rate(cfg, count, 40) == pytest.approx(float(sched(count)), rel=1e-6)


def _run(cfg, iters=2):
    fns = tppo.make_ppo(cfg, device="cpu")
    history = []
    state, _ = tcommon.run_loop(
        fns, total_env_steps=iters * fns.steps_per_iteration, seed=cfg.seed,
        log_interval_iters=1, log_fn=lambda s, m: history.append(m),
    )
    return state, history


_SLICES = {
    "pong": dict(env="PongTPU-v0", torso="nature_cnn", frame_stack=4,
                 num_envs=4, rollout_length=8, num_epochs=2, num_minibatches=1,
                 time_limit_bootstrap=False, lr=8e-3, lr_decay=False),
    "cartpole": dict(env="CartPole-v1", torso="mlp", num_envs=4,
                     rollout_length=8, num_epochs=2, num_minibatches=2),
}


@pytest.mark.parametrize("name", sorted(_SLICES))
def test_slice_end_to_end_is_finite_and_deterministic(name):
    cfg = tppo.PPOConfig(**_SLICES[name], seed=3)
    state, h1 = _run(cfg)
    _, h2 = _run(cfg)
    assert len(h1) == 2 and state.step == 2
    for m in h1:
        for k in ("loss", "policy_loss", "value_loss", "entropy", "approx_kl"):
            assert math.isfinite(m[k]), (k, m)
        assert m["health_finite"] == 1.0
    strip = lambda h: [{k: v for k, v in m.items() if k != "steps_per_sec"} for m in h]
    assert strip(h1) == strip(h2)


@pytest.mark.parametrize("schedule", [
    dict(num_minibatches=4, shuffle="full"),
    dict(num_minibatches=2, shuffle="env"),
])
def test_minibatch_schedules_run(schedule):
    cfg = tppo.PPOConfig(env="CartPole-v1", num_envs=4, rollout_length=8,
                         num_epochs=2, seed=1, **schedule)
    state, h = _run(cfg, iters=1)
    assert state.updates == 2 * cfg.num_minibatches
    assert h[0]["health_finite"] == 1.0


def test_grad_accum_matches_whole_batch():
    """Accumulated slice gradients are the whole-batch gradient: the
    same params after an iteration (float32 sums in another order)."""
    base = dict(env="CartPole-v1", num_envs=8, rollout_length=8,
                num_epochs=2, num_minibatches=1, seed=2)
    s1, _ = _run(tppo.PPOConfig(**base), iters=1)
    s2, _ = _run(tppo.PPOConfig(**base, grad_accum=4), iters=1)
    for (n, a), (_, b) in zip(s1.model.state_dict().items(),
                              s2.model.state_dict().items()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_unported_options_are_refused():
    for opt in (dict(recurrent=True), dict(compact_frames=True),
                dict(normalize_obs=True), dict(num_devices=2)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tppo.make_ppo(tppo.PPOConfig(**opt), device="cpu")


def test_cli_ppo_pong_preset_on_cpu(capsys):
    rc = tcli.main([
        "--preset", "ppo-pong", "--device", "cpu",
        "--set", "num_envs=4", "--set", "rollout_length=8",
        "--total-steps", "64", "--log-interval", "1",
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "health_finite=1" in out and "[train] done: env_steps=64" in out


def test_cli_refuses_unported_presets_and_keeps_set_coercion():
    with pytest.raises(SystemExit, match="not yet ported"):
        tcli.main(["--preset", "a2c-cartpole", "--device", "cpu"])
    args = tcli.build_parser().parse_args(
        ["--preset", "ppo-pong", "--set", "hidden_sizes=32,32",
         "--set", "use_pallas_scan=true", "--seed", "5"])
    algo, cfg = tcli.make_config(args)
    assert algo == "ppo" and cfg.hidden_sizes == (32, 32)
    assert cfg.use_pallas_scan is True and cfg.seed == 5
    assert dataclasses.asdict(cfg)["num_envs"] == 1024


def test_config_and_set_overrides_match_the_jax_package():
    """Same PPOConfig fields and defaults, less the LSTM knobs of the
    recurrent path that is not ported yet, and ``--set`` coerces alike."""
    from actor_critic_algs_on_tensorflow_tpu.algos.ppo import PPOConfig as JPPOConfig
    from actor_critic_algs_on_tensorflow_tpu.utils.config import (
        apply_overrides as japply,
    )
    from actor_critic_algs_on_tensorflow_tpu_torch.utils.config import (
        apply_overrides as tapply,
    )

    unported = {"lstm_size", "lstm_precompute_gates", "lstm_unroll"}

    def ported(cfg):
        d = dataclasses.asdict(cfg)
        return {k: v for k, v in d.items() if k not in unported}

    assert dataclasses.asdict(tppo.PPOConfig()) == ported(JPPOConfig())
    sets = ("num_envs=16", "lr=3e-4", "lr_decay=off", "hidden_sizes=32,16",
            "shuffle=env", "use_pallas_scan=yes")
    assert dataclasses.asdict(tapply(tppo.PPOConfig(), sets)) == \
        ported(japply(JPPOConfig(), sets))
    for field in ("no_such_field", *sorted(unported)):
        with pytest.raises(KeyError):
            tapply(tppo.PPOConfig(), (f"{field}=1",))
