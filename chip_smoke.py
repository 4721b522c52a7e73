#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what comes out.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):

1. device: require CUDA, print the card's name and power limit;
2. build: compile every kernel of the port with ``nvcc`` (sm_90a);
3. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes and the edge cases, with its time beside
   the plain version's and the card's bound;
   (every comparison with a plain version runs with TF32 off, since
   cuDNN runs float32 convolutions in TF32 by default; the slice itself
   runs with PyTorch's defaults, as the CLI does)
4. slice: the ``ppo-pong`` preset at full width (1024 envs x 128 steps,
   Nature-CNN 32/64/64/512 in bf16, 2 whole-batch epochs, seed 0),
   1 warm-up and 3 timed iterations through ``make_ppo``/``run_loop``;
   every loss finite, ``health_finite == 1``, every kernel launched by
   that run, and the policy on the card agreeing with a float32 CPU
   copy of itself on a few observations;
5. trace: one more iteration under ``torch.profiler``, for the device's
   busy time and kernel count per phase.

It prints one JSON line per kernel table and slice summary, and as its
last line ``{"ok": true, "device": {...}}``. Each kernel record names the
TPU kernel it replaces and its median time twice, as ``replaces``/``ms``
and as ``tpu_source``/``kernel_ms``, so readers of either form find them. Needs no network and
starts no process that outlives it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time

# Card constants for the bound (NVIDIA H100 SXM data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def _event_ms(fn, reps: int, warmup: int) -> float:
    """Median time of ``fn`` in ms over ``reps`` runs, each between its
    own pair of CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def float32_exact():
    """TF32 off for float32 convolutions and matmuls, restored after."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"card {torch.cuda.get_device_name(0)}", flush=True)


def phase_build():
    try:
        from actor_critic_algs_on_tensorflow_tpu_torch.ops import linear_scan
    except ModuleNotFoundError as e:
        raise SystemExit(f"chip_smoke: {e}; run this script from the root of "
                         "the repository, beside the port's package") from e

    t0 = time.perf_counter()
    linear_scan.build()
    print(f"[build] linear_backward_scan: {time.perf_counter() - t0:.2f} s",
          flush=True)


def phase_kernels():
    """The scan kernel against its plain version; returns its record."""
    import torch

    from actor_critic_algs_on_tensorflow_tpu_torch.ops import linear_scan

    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs(shape, dtype, with_init):
        deltas = torch.randn(shape, generator=g, device="cuda")
        dones = (torch.rand(shape, generator=g, device="cuda") < 0.01).float()
        decay = 0.99 * 0.95 * (1.0 - dones)
        init = (torch.randn(shape[1:], generator=g, device="cuda").to(dtype)
                if with_init else None)
        return deltas.to(dtype), decay.to(dtype), init

    # (shape, dtype, with init, rtol, atol): float32 at the JAX package's
    # scan-test tolerance; bf16 at bf16 rounding, both outputs in f32.
    cases = [
        ((128, 1024), torch.float32, False, 1e-5, 1e-6),   # main path
        ((13, 37), torch.float32, True, 1e-5, 1e-6),       # unaligned, init
        ((128, 1024), torch.bfloat16, False, 1e-2, 1e-6),
        ((16, 4, 6), torch.float32, False, 1e-5, 1e-6),    # trailing shape
    ]
    main_err = None
    for shape, dtype, with_init, rtol, atol in cases:
        d, dec, init = inputs(shape, dtype, with_init)
        with float32_exact():
            out = linear_scan.linear_backward_scan(d, dec, init)
            torch.cuda.synchronize()
            ref = linear_scan.linear_backward_scan_reference(d, dec, init)
        if out.dtype != dtype or out.shape != d.shape:
            raise AssertionError(f"{shape} {dtype}: got {out.dtype} {tuple(out.shape)}")
        a, b = out.float(), ref.float()
        err = (a - b).abs().max().item()
        ok = torch.allclose(a, b, rtol=rtol, atol=atol)
        print(f"[kernel] linear_backward_scan {list(shape)} {str(dtype)[6:]}"
              f"{' +init' if with_init else ''}: max_abs_err={err:.3g} "
              f"(rtol {rtol}, atol {atol}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version at {shape} {dtype}")
        if main_err is None:
            main_err = err

    t_len, n = 128, 1024
    d, dec, _ = inputs((t_len, n), torch.float32, False)
    kernel_ms = _event_ms(lambda: linear_scan.linear_backward_scan(d, dec), 200, 20)
    plain_ms = _event_ms(lambda: linear_scan.linear_backward_scan_reference(d, dec), 50, 5)
    n_bytes = 3 * t_len * n * 4          # deltas, decay read once; out written once
    n_ops = 2 * t_len * n                # one multiply, one add per element
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOP_PER_S) * 1e3
    bound_by = "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / FP32_FLOP_PER_S else "operations"
    print(f"[kernel] linear_backward_scan [128, 1024] f32: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
          f"{n_bytes} B), library call: none", flush=True)
    return {
        "name": "linear_backward_scan",
        "route": "cuda",
        "source": "actor_critic_algs_on_tensorflow_tpu_torch/csrc/linear_backward_scan.cu",
        "replaces": "actor_critic_algs_on_tensorflow_tpu/ops/pallas_scan.py:52",
        "tpu_source": "ops/pallas_scan.py:52",
        "launches": None,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


class PhaseClock:
    """A ``PhaseMark`` that synchronizes the card at each phase end and
    records the wall time of each phase per iteration, in ms."""

    def __init__(self):
        import torch

        self._sync = torch.cuda.synchronize
        self.rows = []
        self._row = {}
        self._sync()
        self._t = time.perf_counter()

    def __call__(self, phase: str) -> None:
        self._sync()
        now = time.perf_counter()
        self._row[phase] = (now - self._t) * 1e3
        self._t = now
        if phase == "update":
            self.rows.append(self._row)
            self._row = {}


def phase_slice():
    """ppo-pong at full width; returns (launch counts, summary)."""
    import math

    import torch

    from actor_critic_algs_on_tensorflow_tpu_torch.algos import common
    from actor_critic_algs_on_tensorflow_tpu_torch.algos.ppo import PPOConfig, make_ppo
    from actor_critic_algs_on_tensorflow_tpu_torch.cli.train import PRESETS
    from actor_critic_algs_on_tensorflow_tpu_torch.ops import linear_scan

    warmup, timed = 1, 3
    cfg = PPOConfig(**PRESETS["ppo-pong"][1])
    spi = cfg.num_envs * cfg.rollout_length
    cfg = dataclasses.replace(cfg, seed=0, total_env_steps=(warmup + timed) * spi)
    print(f"[slice] ppo-pong: {cfg.num_envs} envs x {cfg.rollout_length} steps, "
          f"torso {cfg.torso} {cfg.compute_dtype}, {cfg.num_epochs} whole-batch "
          f"epochs, seed {cfg.seed}", flush=True)
    fns = make_ppo(cfg, device="cuda")
    state = fns.init(cfg.seed)
    torch.cuda.reset_peak_memory_stats()
    history = []
    clock = PhaseClock()
    linear_scan.linear_backward_scan.launches = 0
    state, _ = common.run_loop(
        fns,
        total_env_steps=cfg.total_env_steps,
        seed=cfg.seed,
        log_interval_iters=1,
        log_fn=lambda steps, m: history.append((steps, m)),
        state=state,
        mark=clock,
    )
    launches = {"linear_backward_scan": linear_scan.linear_backward_scan.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    iters = warmup + timed
    if len(history) != iters or len(clock.rows) != iters:
        raise AssertionError(f"ran {len(history)} iterations, expected {iters}")
    for steps, m in history:
        bad = [k for k in ("loss", "policy_loss", "value_loss", "entropy")
               if not math.isfinite(m[k])]
        if bad or m["health_finite"] != 1.0:
            raise AssertionError(f"iteration at {steps} steps: non-finite {bad} "
                                 f"health_finite={m['health_finite']}")
    if launches["linear_backward_scan"] != iters:
        raise AssertionError(
            f"linear_backward_scan launched {launches['linear_backward_scan']} "
            f"times in {iters} iterations")

    rows = clock.rows[warmup:]
    phase_ms = {p: statistics.mean(r[p] for r in rows) for p in ("rollout", "gae", "update")}
    iter_ms = sum(phase_ms.values())
    summary = {
        "preset": "ppo-pong",
        "num_envs": cfg.num_envs,
        "rollout_length": cfg.rollout_length,
        "timed_iterations": timed,
        "env_steps_per_s": spi / (iter_ms / 1e3),
        "iteration_ms": iter_ms,
        "rollout_ms": phase_ms["rollout"],
        "gae_ms": phase_ms["gae"],
        "update_ms": phase_ms["update"],
        "warmup_iteration_ms": sum(clock.rows[0].values()),
        "peak_allocated_gb": peak_gb,
    }
    print(f"[slice] first iteration: {json.dumps(history[0][1], sort_keys=True)}",
          flush=True)
    print(f"[slice] last iteration: {json.dumps(history[-1][1], sort_keys=True)}",
          flush=True)
    print(f"[slice] {summary['env_steps_per_s']:.0f} env-steps/s; per iteration "
          f"{iter_ms:.1f} ms = rollout {phase_ms['rollout']:.1f} + gae "
          f"{phase_ms['gae']:.3f} + update {phase_ms['update']:.1f}; peak "
          f"allocated {peak_gb:.2f} GB", flush=True)

    # The policy on the card (bf16) against a float32 CPU copy of itself
    # on a few observations: bf16 keeps 8 bits, so 5e-2 of the largest
    # output covers a few roundings per layer.
    cpu_model = type(state.model)(
        state.obs.shape[1:], 6, torso="nature_cnn", dtype=torch.float32)
    cpu_model.load_state_dict({k: v.cpu() for k, v in state.model.state_dict().items()})
    with torch.no_grad(), float32_exact():
        logits, value = state.model(state.obs[:8])
        ref_logits, ref_value = cpu_model(state.obs[:8].cpu())
    for name, got, ref in (("logits", logits, ref_logits), ("value", value, ref_value)):
        err = (got.cpu() - ref).abs().max().item()
        tol = 5e-2 * max(1.0, ref.abs().max().item())
        print(f"[slice] policy {name} card bf16 vs CPU f32: max_abs_err={err:.3g} "
              f"(tol {tol:.3g})", flush=True)
        if not err <= tol:
            raise AssertionError(f"policy {name} on the card disagrees with the CPU")
    return launches, summary, fns, state


def phase_trace(fns, state):
    """One more ppo-pong iteration under ``torch.profiler``: per phase,
    the wall time, the device's busy time (sum of kernel durations) and
    the kernels launched. The profiler adds host time, so the walls
    here are longer than the untraced ones above; the busy times are
    the device's own."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    order = ("rollout", "gae", "update")
    clock = PhaseClock()
    ranges = [record_function(f"smoke_{order[0]}")]

    def mark(phase):
        clock(phase)
        ranges[-1].__exit__(None, None, None)
        i = order.index(phase) + 1
        if i < len(order):
            ranges.append(record_function(f"smoke_{order[i]}"))
            ranges[-1].__enter__()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ranges[0].__enter__()
        fns.iteration(state, mark)
        torch.cuda.synchronize()
    events = prof.events()
    # Device-side events, less the profiler's mirror of each phase range
    # on the device timeline (it spans the phase's kernels).
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and not e.name.startswith("smoke_")]
    if not kernels:
        print("[trace] the profiler recorded no kernels: device time not measured",
              flush=True)
        return None
    spans = {e.name[len("smoke_"):]: e.time_range for e in events
             if e.name.startswith("smoke_") and e.device_type.name == "CPU"}
    trace = {}
    for phase in order:
        span = spans[phase]
        inside = [k for k in kernels
                  if span.start <= k.time_range.start < span.end]
        busy_ms = sum(k.time_range.elapsed_us() for k in inside) / 1e3
        wall_ms = span.elapsed_us() / 1e3
        trace[phase] = {
            "wall_ms": wall_ms,
            "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": len(inside),
        }
        print(f"[trace] {phase}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
              f"(idle share {trace[phase]['idle_share']:.3f}), {len(inside)} kernels",
              flush=True)
    by_name = {}
    for k in kernels:
        by_name[k.name] = by_name.get(k.name, 0.0) + k.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        print(f"[trace] {ms:9.2f} ms  {name[:110]}", flush=True)
    return trace


def main() -> int:
    phase_device()
    phase_build()
    scan_record = phase_kernels()
    launches, summary, fns, state = phase_slice()
    scan_record["launches"] = launches["linear_backward_scan"]
    summary["trace"] = phase_trace(fns, state)
    print(json.dumps({"slice": summary}), flush=True)
    print(json.dumps({"kernels": [scan_record]}), flush=True)

    import torch

    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
