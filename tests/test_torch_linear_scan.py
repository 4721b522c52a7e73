"""The port's backward linear scan against the JAX package's
``ops/pallas_scan.py::linear_backward_scan`` (run as
``tests/test_pallas_scan.py`` runs it on the CPU: interpret mode).

The same numpy inputs, made from a seed, go through both. float32 is
held at the JAX scan tests' tolerance, rtol 1e-5 and atol 1e-6. JAX is
imported inside the parity helper, so the card test below also runs
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_linear_scan.py -m gpu
"""

import numpy as np
import pytest
import torch

from actor_critic_algs_on_tensorflow_tpu_torch.ops import linear_scan

torch.set_num_threads(1)


def _jax_scan(deltas, decay, init=None):
    import jax.numpy as jnp

    from actor_critic_algs_on_tensorflow_tpu.ops.pallas_scan import (
        linear_backward_scan,
    )

    out = linear_backward_scan(
        jnp.asarray(deltas), jnp.asarray(decay),
        None if init is None else jnp.asarray(init),
    )
    return np.asarray(out.astype(jnp.float32)), str(out.dtype)


def _inputs(seed, shape, with_init=False):
    rng = np.random.default_rng(seed)
    deltas = rng.normal(size=shape).astype(np.float32)
    decay = (np.abs(rng.normal(size=shape)) * 0.9).astype(np.float32)
    init = rng.normal(size=shape[1:]).astype(np.float32) if with_init else None
    return deltas, decay, init


@pytest.mark.parametrize(
    "shape,with_init",
    [
        ((13, 37), False),     # deliberately unaligned with (8, 128) tiles
        ((13, 37), True),      # with init
        ((5, 3), True),
        ((16, 4, 6), False),   # trailing shape, flattened to [T, 24]
        ((16, 4, 6), True),
    ],
)
def test_plain_scan_matches_jax_f32(shape, with_init):
    deltas, decay, init = _inputs(0, shape, with_init)
    want, _ = _jax_scan(deltas, decay, init)
    got = linear_scan.linear_backward_scan(
        torch.from_numpy(deltas), torch.from_numpy(decay),
        None if init is None else torch.from_numpy(init),
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_plain_scan_bf16_input_matches_jax():
    """bf16 in, bf16 out, f32 accumulation on both sides: the outputs
    differ by at most one bf16 rounding (rtol 1e-2 covers 2^-7)."""
    import jax.numpy as jnp

    deltas, decay, _ = _inputs(1, (13, 37))
    d16 = jnp.asarray(deltas, jnp.bfloat16)
    g16 = jnp.asarray(decay, jnp.bfloat16)
    want, want_dtype = _jax_scan(d16, g16)
    got = linear_scan.linear_backward_scan(
        torch.from_numpy(np.array(d16.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(np.array(g16.astype(jnp.float32))).bfloat16(),
    )
    assert want_dtype == "bfloat16" and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-6)


def test_plain_scan_matches_numpy_oracle():
    deltas, decay, init = _inputs(2, (13, 37), with_init=True)
    acc = init.astype(np.float64)
    expect = np.zeros(deltas.shape)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + decay[t] * acc
        expect[t] = acc
    got = linear_scan.linear_backward_scan_reference(
        torch.from_numpy(deltas), torch.from_numpy(decay), torch.from_numpy(init)
    )
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-6)


def test_scan_rejects_bad_inputs_and_other_devices():
    d = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="one shape"):
        linear_scan.linear_backward_scan(d, torch.zeros(4, 2))
    with pytest.raises(ValueError, match="trailing shape"):
        linear_scan.linear_backward_scan(d, d, torch.zeros(4))
    # Neither the kernel's nor the CPU's device: no silent plain path.
    meta = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="not meta"):
        linear_scan.linear_backward_scan(meta, meta)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_tensor_launches_the_kernel_never_the_plain_path(cuda_device, monkeypatch):
    def plain_must_not_run(*args, **kwargs):
        raise AssertionError("plain path reached with a CUDA tensor")

    monkeypatch.setattr(
        linear_scan, "linear_backward_scan_reference", plain_must_not_run
    )
    deltas, decay, init = _inputs(3, (13, 37), with_init=True)
    before = linear_scan.linear_backward_scan.launches
    got = linear_scan.linear_backward_scan(
        torch.from_numpy(deltas).to(cuda_device),
        torch.from_numpy(decay).to(cuda_device),
        torch.from_numpy(init).to(cuda_device),
    )
    torch.cuda.synchronize()
    assert linear_scan.linear_backward_scan.launches == before + 1
    monkeypatch.undo()
    want = linear_scan.linear_backward_scan_reference(
        torch.from_numpy(deltas), torch.from_numpy(decay), torch.from_numpy(init)
    )
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
