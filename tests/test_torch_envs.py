"""The port's batched envs against the JAX package's vmapped envs.

Each step starts both sides from one state, built with numpy from a
seed, with the same actions. Torch's generator never draws JAX's
numbers, so a comparison covers only what the draws do not reach:
where Pong scores a point, the serve's ``y``/``vy`` are random and are
held to their ranges; everything else must agree.

Tolerances: float32 state at atol 1e-5 (one float32 ulp at the Pong
court's scale of 84 is 7.6e-6); CartPole at rtol 1e-5, atol 1e-6
(``sin``/``cos`` may differ by an ulp between libraries). Frames are
compared byte for byte.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_algs_on_tensorflow_tpu import envs as jenvs
from actor_critic_algs_on_tensorflow_tpu_torch import envs as tenvs
from actor_critic_algs_on_tensorflow_tpu_torch.envs import cartpole as tcartpole
from actor_critic_algs_on_tensorflow_tpu_torch.envs import pong as tpong

torch.set_num_threads(1)

_PONG_FLOATS = ("ball_x", "ball_y", "ball_vx", "ball_vy", "agent_y", "opp_y")
_PONG_INTS = ("agent_score", "opp_score", "t")


def _random_pong_state(rng, b):
    sign = np.where(rng.random(b) < 0.5, -1.0, 1.0)
    return {
        "ball_x": rng.uniform(0.0, 84.0, b),
        "ball_y": rng.uniform(0.0, 84.0, b),
        "ball_vx": sign * rng.uniform(1.5, 3.0, b),
        "ball_vy": rng.uniform(-2.0, 2.0, b),
        "agent_y": rng.uniform(4.0, 79.0, b),
        "opp_y": rng.uniform(4.0, 79.0, b),
        "agent_score": rng.integers(0, 21, b),
        "opp_score": rng.integers(0, 21, b),
        "t": rng.integers(0, 100, b),
    }


def _jax_pong_state(d):
    from actor_critic_algs_on_tensorflow_tpu.envs.pong import PongState

    return PongState(**{
        k: jnp.asarray(v, jnp.int32 if k in _PONG_INTS else jnp.float32)
        for k, v in d.items()
    })


def _torch_pong_state(d):
    return tpong.PongState(**{
        k: torch.from_numpy(np.asarray(
            v, np.int32 if k in _PONG_INTS else np.float32).copy())
        for k, v in d.items()
    })


def _as_numpy(state, fields):
    return {k: np.asarray(getattr(state, k)) for k in fields}


def test_pong_steps_and_frames_match_jax():
    b = 96
    rng = np.random.default_rng(0)
    jenv, tenv = jenvs.PongTPU(), tenvs.PongTPU()
    jparams, tparams = jenv.default_params(), tenv.default_params()
    jstep = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0, 0, None)), static_argnums=3)
    gen = torch.Generator().manual_seed(0)
    d = _random_pong_state(rng, b)
    n_scored = n_quiet = 0
    for i in range(12):
        actions = rng.integers(0, 6, b)
        keys = jax.random.split(jax.random.PRNGKey(i), b)
        js, jobs, jrew, jdone, jinfo = jstep(
            keys, _jax_pong_state(d), jnp.asarray(actions, jnp.int32), jparams)
        ts, tobs, trew, tdone, tinfo = tenv.step(
            gen, _torch_pong_state(d), torch.from_numpy(actions), tparams)
        jn = _as_numpy(js, _PONG_FLOATS + _PONG_INTS)
        tn = _as_numpy(ts, _PONG_FLOATS + _PONG_INTS)
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        for k in ("terminated", "truncated"):
            np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]))
        scored = np.asarray(jrew) != 0
        quiet = ~scored
        for k in _PONG_INTS + ("agent_y", "opp_y"):
            np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=1e-5)
        for k in ("ball_x", "ball_y", "ball_vx", "ball_vy"):
            np.testing.assert_allclose(tn[k][quiet], jn[k][quiet], rtol=0, atol=1e-5)
        # A point was scored: the serve's x and vx are exact, y and vy
        # are draws held to their ranges.
        np.testing.assert_array_equal(tn["ball_x"][scored], jn["ball_x"][scored])
        np.testing.assert_array_equal(tn["ball_vx"][scored], jn["ball_vx"][scored])
        assert np.all((tn["ball_y"][scored] >= 21.0) & (tn["ball_y"][scored] <= 63.0))
        assert np.all((tn["ball_vy"][scored] >= -1.0) & (tn["ball_vy"][scored] <= 1.0))
        assert tobs.shape == (b, 84, 84, 1) and tobs.dtype == torch.uint8
        np.testing.assert_array_equal(tobs.numpy()[quiet], np.asarray(jobs)[quiet])
        n_scored += int(scored.sum())
        n_quiet += int(quiet.sum())
        # Go on from the JAX state (its serves), so both sides keep
        # starting from one state.
        d = jn
    assert n_scored > 20 and n_quiet > 500, (n_scored, n_quiet)


def test_pong_reset_frames_match_jax_render():
    """A reset state rendered on both sides gives the same bytes."""
    tenv = tenvs.PongTPU()
    params = tenv.default_params()
    ts, tobs = tenv.reset(torch.Generator().manual_seed(1), params, 16)
    jenv = jenvs.PongTPU()
    d = {k: getattr(ts, k).numpy() for k in _PONG_FLOATS + _PONG_INTS}
    jobs = jax.vmap(jenv._obs, in_axes=(0, None))(_jax_pong_state(d), jenv.default_params())
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert np.all(np.abs(d["ball_vx"]) == 1.5) and np.all(d["ball_x"] == 42.0)


def test_cartpole_steps_match_jax():
    b = 64
    rng = np.random.default_rng(2)
    jenv, tenv = jenvs.CartPole(), tenvs.CartPole()
    jparams, tparams = jenv.default_params(), tenv.default_params()
    jstep = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0, 0, None)))
    from actor_critic_algs_on_tensorflow_tpu.envs.cartpole import CartPoleState

    names = ("x", "x_dot", "theta", "theta_dot")
    d = {k: rng.uniform(-0.25, 0.25, b).astype(np.float32) for k in names}
    d["t"] = rng.integers(490, 500, b).astype(np.int32)
    for i in range(15):
        actions = rng.integers(0, 2, b)
        keys = jax.random.split(jax.random.PRNGKey(i), b)
        js, jobs, jrew, jdone, jinfo = jstep(
            keys, CartPoleState(**{k: jnp.asarray(v) for k, v in d.items()}),
            jnp.asarray(actions, jnp.int32), jparams)
        ts, tobs, trew, tdone, tinfo = tenv.step(
            None, tcartpole.CartPoleState(**{k: torch.from_numpy(v.copy()) for k, v in d.items()}),
            torch.from_numpy(actions), tparams)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(
            tinfo["terminated"].numpy(), np.asarray(jinfo["terminated"]))
        np.testing.assert_array_equal(ts.t.numpy(), np.asarray(js.t))
        d = {k: np.asarray(getattr(js, k)) for k in names + ("t",)}
    assert tenv.observation_space(tparams).shape == (4,)
    assert tenv.action_space(tparams).n == 2


def _pong_stack_state(state):
    """VecEnv(EpisodeStats(AutoReset(FrameStack(Pong)))) nests as
    EpisodeStatsState -> FrameStackState -> PongState."""
    return state.inner, state.inner.inner


def test_wrapper_stack_on_a_forced_done_matches_jax():
    """Every env truncates at step 3: on the done step the obs is the
    new episode's first frame tiled 4 times, ``final_obs`` is the
    pre-reset stack, and the episode stats close the episode."""
    b, k = 3, 4
    tenv, _ = tenvs.make("PongTPU-v0", num_envs=b, frame_stack=k)
    jenv, _ = jenvs.make("PongTPU-v0", num_envs=b, frame_stack=k)
    tparams = dataclasses.replace(tenvs.PongParams(), max_steps=3)
    jparams = jenvs.PongParams(max_steps=3)
    gen = torch.Generator().manual_seed(0)
    ts, tobs = tenv.reset(gen, tparams)
    js, jobs = jenv.reset(jax.random.PRNGKey(0), jparams)
    assert tobs.shape == (b, 84, 84, k) and tuple(jobs.shape) == (b, 84, 84, k)
    for obs in (tobs.numpy(), np.asarray(jobs)):  # reset tiles the first frame
        assert all(np.array_equal(obs[..., c], obs[..., 0]) for c in range(k))
    actions = np.array([2, 3, 0])
    for step in range(1, 4):
        prev = tobs.clone()
        ts, tobs, trew, tdone, tinfo = tenv.step(
            gen, ts, torch.from_numpy(actions), tparams)
        js, jobs, jrew, jdone, jinfo = jenv.step(
            jax.random.PRNGKey(step), js, jnp.asarray(actions), jparams)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tinfo["truncated"].numpy(), np.asarray(jinfo["truncated"]))
        for key in ("episode_length", "episode_return", "done_episode"):
            np.testing.assert_array_equal(tinfo[key].numpy(), np.asarray(jinfo[key]))
        # final_obs is the stack before any reset: the old stack shifted
        # by one frame.
        np.testing.assert_array_equal(
            tinfo["final_obs"][..., : k - 1].numpy(), prev[..., 1:].numpy())
        if step < 3:
            assert not tdone.any()
            np.testing.assert_array_equal(tobs.numpy(), tinfo["final_obs"].numpy())
    assert tdone.all() and np.asarray(jdone).all()
    for obs in (tobs.numpy(), np.asarray(jobs)):  # the new episode's first frame
        assert all(np.array_equal(obs[..., c], obs[..., 0]) for c in range(k))
    assert not np.array_equal(tobs.numpy(), tinfo["final_obs"].numpy())
    fs, pong = _pong_stack_state(ts)
    assert pong.t.tolist() == [0] * b and pong.agent_score.tolist() == [0] * b
    np.testing.assert_array_equal(fs.frames.numpy(), tobs.numpy())
    np.testing.assert_array_equal(tinfo["episode_length"].numpy(), [3.0] * b)
    assert ts.ep_length.tolist() == [0.0] * b and ts.last_length.tolist() == [3.0] * b


def test_auto_reset_resets_only_the_done_envs():
    """A done env is reset; the others go on from where they were."""
    b = 4
    tenv, _ = tenvs.make("PongTPU-v0", num_envs=b, frame_stack=4)
    params = dataclasses.replace(tenvs.PongParams(), max_steps=5)
    gen = torch.Generator().manual_seed(3)
    ts, tobs = tenv.reset(gen, params)
    fs, pong = _pong_stack_state(ts)
    pong.t = torch.tensor([0, 4, 0, 4], dtype=torch.int32)  # envs 1, 3 end next step
    ts, tobs, _, tdone, tinfo = tenv.step(gen, ts, torch.zeros(b, dtype=torch.long), params)
    assert tdone.tolist() == [0.0, 1.0, 0.0, 1.0]
    fs, pong = _pong_stack_state(ts)
    assert pong.t.tolist() == [1, 0, 1, 0]
    np.testing.assert_array_equal(tinfo["episode_length"].numpy(), [1.0, 1.0, 1.0, 1.0])
    for e in (0, 2):  # still running: stack shifted, not tiled
        np.testing.assert_array_equal(tobs[e].numpy(), tinfo["final_obs"][e].numpy())
    for e in (1, 3):
        assert all(torch.equal(tobs[e, ..., c], tobs[e, ..., 0]) for c in range(4))
    assert ts.ep_length.tolist() == [1.0, 0.0, 1.0, 0.0]


def test_make_refuses_unported_envs():
    with pytest.raises(KeyError, match="not yet ported"):
        tenvs.make("BreakoutTPU-v0")
