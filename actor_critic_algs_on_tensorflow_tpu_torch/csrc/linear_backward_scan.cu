// Backward linear recurrence for GAE(lambda) and V-trace, for Hopper (sm_90a).
//
//   acc_t = deltas_t + decay_t * acc_{t+1},   acc_T = init (0 when init is null)
//
// over the leading (time) axis of row-major [T, N] float32 arrays.
//
// Replaces the TPU kernel actor_critic_algs_on_tensorflow_tpu/ops/pallas_scan.py
// (`linear_backward_scan`, body `_kernel`). That kernel folds `init` in as an
// extra row with decay 0 and pads to (8, 128) tiles, one 128-lane block per
// sequential grid step; both are TPU tiling and are dropped here. Each column
// is an independent recurrence, so one thread owns one column and walks time
// in a register; the ragged edge of the grid is masked with `j < N`.
//
// Bound on an H100: the work is 3 * T * N * 4 bytes (deltas and decay read
// once, out written once; 1.57 MB at the PPO shape [128, 1024], about 0.47 us
// at 3.35 TB/s) and 2 * T * N flops. In practice the kernel is latency-bound:
// T dependent load-multiply-add-store steps on only N threads (1024 threads are 8
// blocks of 128 on 132 SMs). Neighbouring threads read neighbouring addresses
// at every step, so each warp's loads are coalesced; issuing loads ahead of
// the dependent chain and putting more columns in flight are left for later.

#include <cuda_runtime.h>

namespace {

__global__ void linear_backward_scan_kernel(const float* __restrict__ deltas,
                                            const float* __restrict__ decay,
                                            const float* __restrict__ init,
                                            float* __restrict__ out,
                                            int t_len, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float acc = init != nullptr ? init[j] : 0.0f;
  for (int t = t_len - 1; t >= 0; --t) {
    const size_t k = static_cast<size_t>(t) * n + j;
    // Multiply, round, add, round: the plain PyTorch version's two
    // roundings, so the two agree to the bit. A fused multiply-add
    // differs by one rounding per step, and where the accumulator
    // cancels towards zero that difference exceeds rtol 1e-5.
    acc = __fadd_rn(deltas[k], __fmul_rn(decay[k], acc));
    out[k] = acc;
  }
}

constexpr int kThreads = 128;

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(), so a refused launch is reported to the caller.
extern "C" int linear_backward_scan_f32(const float* deltas, const float* decay,
                                        const float* init, float* out,
                                        int t_len, int n, cudaStream_t stream) {
  if (t_len <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + kThreads - 1) / kThreads;
  linear_backward_scan_kernel<<<blocks, kThreads, 0, stream>>>(
      deltas, decay, init, out, t_len, n);
  return static_cast<int>(cudaGetLastError());
}
