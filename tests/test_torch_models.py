"""The port's ``DiscreteActorCritic`` with Flax params transplanted
(``utils/transplant.py::from_flax``) against the JAX package's module.

Tolerances: float32 forward at atol 1e-4 (convolutions and dense
layers sum thousands of products in another order); float32 gradients
of a fixed scalar loss at rtol 1e-4, atol 1e-5; the bfloat16 forward at
bf16's own precision, 3e-2 of the output scale (8 mantissa bits,
rounded again after every layer on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_algs_on_tensorflow_tpu.models import networks as jnets
from actor_critic_algs_on_tensorflow_tpu_torch.models import networks as tnets
from actor_critic_algs_on_tensorflow_tpu_torch.utils.transplant import from_flax

torch.set_num_threads(1)

_CASES = {
    "nature_cnn": ((84, 84, 4), 6),
    "mlp": ((4,), 2),
}


def _obs(torso, n, seed):
    rng = np.random.default_rng(seed)
    shape, _ = _CASES[torso]
    if torso == "nature_cnn":
        # Sparse bright pixels, as Pong frames are.
        return ((rng.random((n,) + shape) < 0.05) * 255).astype(np.uint8)
    return rng.normal(size=(n,) + shape).astype(np.float32)


def _pair(torso, jdtype=jnp.float32, tdtype=torch.float32, seed=0):
    shape, n_act = _CASES[torso]
    jmodel = jnets.DiscreteActorCritic(num_actions=n_act, torso=torso, dtype=jdtype)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(_obs(torso, 1, seed)))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tmodel = tnets.DiscreteActorCritic(shape, n_act, torso=torso, dtype=tdtype)
    missing = tmodel.load_state_dict(from_flax(params_np), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    return jmodel, params, tmodel


@pytest.mark.parametrize("torso", ["nature_cnn", "mlp"])
def test_transplanted_forward_matches_flax_f32(torso):
    jmodel, params, tmodel = _pair(torso)
    obs = _obs(torso, 5, 1)
    jl, jv = jmodel.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = tmodel(torch.from_numpy(obs))
    assert tl.dtype == torch.float32 and tv.shape == (5,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-4)


@pytest.mark.parametrize("torso", ["nature_cnn", "mlp"])
def test_transplanted_gradients_match_flax_f32(torso):
    """Gradients of one fixed scalar loss, mapped to the port's layouts
    by the same transplant as the params."""
    jmodel, params, tmodel = _pair(torso)
    obs = _obs(torso, 6, 2)
    rng = np.random.default_rng(3)
    actions = rng.integers(0, _CASES[torso][1], 6)
    targets = rng.normal(size=6).astype(np.float32)

    def jloss(p):
        logits, value = jmodel.apply(p, jnp.asarray(obs))
        logp = jax.nn.log_softmax(logits)[jnp.arange(6), actions]
        return -logp.mean() + ((value - targets) ** 2).mean()

    jgrads = from_flax(jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(params)))
    logits, value = tmodel(torch.from_numpy(obs))
    logp = torch.log_softmax(logits, -1)[torch.arange(6), torch.from_numpy(actions)]
    loss = -logp.mean() + ((value - torch.from_numpy(targets)) ** 2).mean()
    loss.backward()
    tgrads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(tgrads) == set(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(
            tgrads[name].numpy(), g.numpy(), rtol=1e-4, atol=1e-5, err_msg=name
        )


@pytest.mark.parametrize("torso", ["nature_cnn", "mlp"])
def test_transplanted_forward_matches_flax_bf16(torso):
    jmodel, params, tmodel = _pair(torso, jnp.bfloat16, torch.bfloat16)
    obs = _obs(torso, 5, 4)
    jl, jv = jmodel.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = tmodel(torch.from_numpy(obs))
    assert tl.dtype == torch.float32 and jl.dtype == jnp.float32
    for got, want in ((tl, jl), (tv, jv)):
        want = np.asarray(want)
        tol = 3e-2 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_nature_cnn_flattens_in_nhwc_order():
    """The dense layer after the convs sees the activation in Flax's
    NHWC flatten order: permuting one channel's spatial slice changes
    exactly the dense inputs Flax's order predicts."""
    cnn = tnets.NatureCNN((84, 84, 4))
    x = torch.zeros(1, 64, 7, 7)
    x[0, 5, 2, 3] = 1.0  # channel 5 at (h=2, w=3)
    flat = x.permute(0, 2, 3, 1).reshape(1, -1)
    assert int(flat.argmax()) == (2 * 7 + 3) * 64 + 5
    assert cnn.dense.in_features == 7 * 7 * 64


def test_unported_torso_is_refused():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tnets.DiscreteActorCritic((4,), 2, torso="frame_transformer")
