"""Backward linear recurrence shared by GAE(lambda), V-trace and n-step
returns, as a hand-written CUDA kernel with its plain PyTorch version.

    acc_t = delta_t + decay_t * acc_{t+1},    acc_T = init

  * GAE:       delta = TD-error,            decay = gamma * lam * (1 - done)
  * V-trace:   delta = rho * TD-error,      decay = gamma * (1-done) * c
  * n-step:    delta = reward,              decay = gamma * (1 - done),
               init  = bootstrap value

Counterpart of the JAX package's ``ops/pallas_scan.py``. The kernel
source is ``csrc/linear_backward_scan.cu``; it is built with ``nvcc``
at first use (``utils/cuda_build.py``). :func:`linear_backward_scan`
picks its route by the device of its input alone: a CUDA tensor always
launches the kernel, a CPU tensor runs
:func:`linear_backward_scan_reference`. Any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from actor_critic_algs_on_tensorflow_tpu_torch.utils import cuda_build

KERNEL_NAME = "linear_backward_scan"


def linear_backward_scan_reference(
    deltas: torch.Tensor,
    decay: torch.Tensor,
    init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version: a Python loop over time in float32.

    ``deltas``/``decay``: ``[T, ...]``; ``init``: optional ``[...]``.
    Returns ``[T, ...]`` in the dtype of ``deltas``.
    """
    d = deltas.to(torch.float32)
    g = decay.to(torch.float32)
    out = torch.empty_like(d)
    if init is None:
        acc = torch.zeros_like(d[0]) if d.shape[0] else None
    else:
        acc = init.to(torch.float32).reshape(d.shape[1:])
    for t in range(d.shape[0] - 1, -1, -1):
        acc = d[t] + g[t] * acc
        out[t] = acc
    return out.to(deltas.dtype)


def build():
    """Compile (at first call) and load the kernel; returns its C entry."""
    lib = cuda_build.load(KERNEL_NAME)
    fn = lib.linear_backward_scan_f32
    if fn.argtypes is None:
        # Every pointer and the stream as c_void_p: left undeclared,
        # ctypes would pass them as 32-bit ints and cut the addresses.
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def linear_backward_scan(
    deltas: torch.Tensor,
    decay: torch.Tensor,
    init: torch.Tensor | None = None,
) -> torch.Tensor:
    """``acc_t = deltas_t + decay_t * acc_{t+1}`` over axis 0.

    ``deltas``/``decay``: ``[T, ...]`` of any float dtype and trailing
    shape, accumulated in float32. ``init``: optional ``[...]`` starting
    accumulator (``acc_T``; zero when ``None``). Returns ``[T, ...]`` in
    the dtype of ``deltas``. On a CUDA tensor it launches the kernel and
    adds one to ``linear_backward_scan.launches``; on a CPU tensor it
    runs the plain version.
    """
    if deltas.shape != decay.shape:
        raise ValueError(
            f"deltas {tuple(deltas.shape)} and decay {tuple(decay.shape)} "
            "must have one shape"
        )
    if deltas.dim() < 1:
        raise ValueError("deltas must have a leading time axis")
    batch_shape = deltas.shape[1:]
    if init is not None and init.shape != batch_shape:
        raise ValueError(
            f"init {tuple(init.shape)} must be the trailing shape "
            f"{tuple(batch_shape)}"
        )
    devices = {deltas.device, decay.device}
    if init is not None:
        devices.add(init.device)
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devices))}")
    if deltas.device.type == "cpu":
        return linear_backward_scan_reference(deltas, decay, init)
    if deltas.device.type != "cuda":
        raise ValueError(
            f"linear_backward_scan runs on cuda (kernel) or cpu (plain "
            f"version), not {deltas.device}"
        )

    t_len = deltas.shape[0]
    n = batch_shape.numel()
    if n >= 2**31:
        raise ValueError(f"{n} columns exceed the kernel's int32 index")
    d2 = deltas.to(torch.float32).reshape(t_len, n).contiguous()
    g2 = decay.to(torch.float32).reshape(t_len, n).contiguous()
    i2 = None if init is None else init.to(torch.float32).reshape(n).contiguous()
    out = torch.empty((t_len, n), dtype=torch.float32, device=deltas.device)
    if t_len and n:
        fn = build()
        with torch.cuda.device(deltas.device):
            stream = torch.cuda.current_stream(deltas.device).cuda_stream
            rc = fn(
                d2.data_ptr(), g2.data_ptr(),
                None if i2 is None else i2.data_ptr(),
                out.data_ptr(), t_len, n, stream,
            )
        if rc != 0:
            raise RuntimeError(
                f"linear_backward_scan launch failed: cudaError {rc}"
            )
        linear_backward_scan.launches += 1
    return out.reshape(deltas.shape).to(deltas.dtype)


linear_backward_scan.launches = 0
