"""The port's ops against the JAX package's on the same numpy inputs.

Tolerances: float32 elementwise ops and reductions at rtol 1e-5,
atol 1e-6 (the JAX package's own op-test tolerance); reductions over a
few hundred elements may round in another order, which stays inside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_algs_on_tensorflow_tpu import ops as jops
from actor_critic_algs_on_tensorflow_tpu.algos import common as jcommon
from actor_critic_algs_on_tensorflow_tpu_torch import ops as tops
from actor_critic_algs_on_tensorflow_tpu_torch.algos import common as tcommon

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=rtol, atol=atol,
    )


def _rollout(seed, T=17, B=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    dones = (rng.random((T, B)) < 0.2).astype(np.float32)
    # Terminations are a subset of dones; the rest are truncations.
    terminations = dones * (rng.random((T, B)) < 0.5).astype(np.float32)
    return dict(
        rewards=f(T, B), values=f(T, B), dones=dones, last_value=f(B),
        terminations=terminations, truncation_values=f(T, B),
    )


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bootstrap", [False, True])
def test_gae_matches_jax(seed, bootstrap):
    r = _rollout(seed)
    kw = dict(gamma=0.99, lam=0.95)
    if bootstrap:
        kw.update(terminations=r["terminations"],
                  truncation_values=r["truncation_values"])
    a0, r0 = jops.gae_advantages(
        r["rewards"], r["values"], r["dones"], r["last_value"],
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()},
    )
    a1, r1 = tops.gae_advantages(
        _t(r["rewards"]), _t(r["values"]), _t(r["dones"]), _t(r["last_value"]),
        **{k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()},
    )
    _close(a1, a0)
    _close(r1, r0)


def test_discounted_returns_matches_jax():
    r = _rollout(2)
    want = jops.discounted_returns(
        r["rewards"], r["dones"], jnp.asarray(r["last_value"]), gamma=0.97
    )
    got = tops.discounted_returns(
        _t(r["rewards"]), _t(r["dones"]), _t(r["last_value"]), gamma=0.97
    )
    _close(got, want)


def test_categorical_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(7, 6)) * 2.0).astype(np.float32)
    actions = rng.integers(0, 6, size=7)
    jd = jops.Categorical(jnp.asarray(logits))
    td = tops.Categorical(_t(logits))
    _close(td.log_prob(_t(actions)), jd.log_prob(jnp.asarray(actions)))
    _close(td.entropy(), jd.entropy())
    _close(td.mode(), jd.mode())
    other = (rng.normal(size=(7, 6))).astype(np.float32)
    _close(td.kl(tops.Categorical(_t(other))),
           jd.kl(jops.Categorical(jnp.asarray(other))))


def test_categorical_sample_follows_the_softmax():
    """Torch's draws are not JAX's: hold the sample frequencies to the
    probabilities instead (20k draws: 4 sigma of a binomial is < 0.015)."""
    logits = torch.tensor([[0.0, 1.0, -1.0, 2.0]]).expand(20_000, 4)
    g = torch.Generator().manual_seed(0)
    a = tops.Categorical(logits).sample(g)
    freq = torch.bincount(a, minlength=4).float() / a.numel()
    _close(freq, torch.softmax(logits[0], -1), rtol=0, atol=0.015)


def test_diag_gaussian_matches_jax():
    rng = np.random.default_rng(4)
    mean, log_std, x = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3))
    jd = jops.DiagGaussian(jnp.asarray(mean), jnp.asarray(log_std))
    td = tops.DiagGaussian(_t(mean), _t(log_std))
    _close(td.log_prob(_t(x)), jd.log_prob(jnp.asarray(x)))
    _close(td.entropy(), jd.entropy())


@pytest.mark.parametrize("clip_eps", [0.1, 0.2])
def test_ppo_losses_match_jax(clip_eps):
    rng = np.random.default_rng(5)
    n = 257
    lp, old_lp = (rng.normal(size=n).astype(np.float32) * 0.3 for _ in range(2))
    adv = rng.normal(size=n).astype(np.float32)
    want = jops.ppo_clip_loss(jnp.asarray(lp), jnp.asarray(old_lp),
                              jnp.asarray(adv), clip_eps=clip_eps)
    got = tops.ppo_clip_loss(_t(lp), _t(old_lp), _t(adv), clip_eps=clip_eps)
    for field in ("policy_loss", "clip_fraction", "approx_kl"):
        _close(getattr(got, field), getattr(want, field))
    values, old_values, targets = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    _close(
        tops.clipped_value_loss(_t(values), _t(old_values), _t(targets), clip_eps=clip_eps),
        jops.clipped_value_loss(jnp.asarray(values), jnp.asarray(old_values),
                                jnp.asarray(targets), clip_eps=clip_eps),
    )
    _close(tops.value_loss(_t(values), _t(targets)),
           jops.value_loss(jnp.asarray(values), jnp.asarray(targets)))
    _close(tops.normalize_advantages(_t(adv)),
           jops.normalize_advantages(jnp.asarray(adv)))


def test_global_normalize_advantages_matches_jax():
    rng = np.random.default_rng(6)
    adv = (rng.normal(size=(32, 8)) * 3.0 + 1.0).astype(np.float32)
    want = jcommon.global_normalize_advantages(jnp.asarray(adv), axis_name=None)
    _close(tcommon.global_normalize_advantages(_t(adv)), want)


def test_episode_metrics_match_jax():
    rng = np.random.default_rng(7)
    info = {
        "episode_return": rng.normal(size=(9, 4)).astype(np.float32),
        "done_episode": (rng.random((9, 4)) < 0.3).astype(np.float32),
    }
    want = jcommon.episode_metrics({k: jnp.asarray(v) for k, v in info.items()},
                                   axis_name=None)
    got = tcommon.episode_metrics({k: _t(v) for k, v in info.items()})
    for k in ("episodes", "avg_return"):
        _close(got[k], want[k])
