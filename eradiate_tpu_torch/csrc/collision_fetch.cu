// Collision fetch of the plane-parallel tracer, for Hopper (sm_90a).
//
// Replaces the TPU kernel collision_fetch_pallas
// (eradiate_tpu/ops/pallas/collision_fetch.py) and the one-hot hi/lo-bf16
// matmul form of eradiate_tpu/ops/medium.py collision_fetch that the TPU
// runs. It computes what medium.collision_fetch returns, exactly, not the
// TPU's bf16 approximation: for each lane b with sampled vertical optical
// depth tau_q[b],
//
//   idx   = clamp(upper_bound(tau_levels, tau_q) - 1, 0, L - 1)
//   frac  = clamp((tau_q - t0) / max(t1 - t0, 1e-30), 0, 1)
//   z     = z0 + frac * (z1 - z0)
//   fetched[k, b] = tables[k, idx]          (k < K)
//
// with (t0, t1) and (z0, z1) the levels bracketing layer idx. Ties, tau_q
// at the top level and runs of equal levels go to the upper bound, as
// torch.searchsorted(right=True) does.
//
// Design: one thread per lane. Each block stages tau_levels ((L+1) floats,
// 4.8 KB for a 1200-layer column) in shared memory and binary-searches it;
// z0, z1 and the K table values are loaded straight from global memory,
// where the few-KB tables stay hot in L1/L2. The arithmetic is written with
// round-to-nearest intrinsics so nvcc cannot contract it into an FMA: the
// kernel then equals its plain PyTorch twin on the card bit for bit.
//
// What bounds it on this card: per lane it moves (K + 3) floats of global
// traffic (tau_q in; z, layer and K fetched values out) plus table reads
// that hit cache, and does ~log2(L+1) dependent shared-memory probes. At the
// c1 lane counts (1e4 to 1e6 lanes, K = 3) that is a few MB per launch, so
// the kernel is latency-bound (launch and the dependent search), far from
// the 3.35 TB/s memory roof; it is one launch per bounce in an eager loop.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void collision_fetch_kernel(const float* __restrict__ tau_q,
                                       const float* __restrict__ z_levels,
                                       const float* __restrict__ tau_levels,
                                       const float* __restrict__ tables,
                                       float* __restrict__ z_out,
                                       int* __restrict__ layer_out,
                                       float* __restrict__ fetched_out,
                                       int B, int L, int K) {
  extern __shared__ float s_tau[];  // L + 1 levels
  for (int i = threadIdx.x; i <= L; i += blockDim.x) s_tau[i] = tau_levels[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // ragged last block

  const float q = tau_q[b];
  int lo = 0, hi = L + 1;  // upper bound: first level > q
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_tau[mid] <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int idx = min(max(lo - 1, 0), L - 1);

  const float t0 = s_tau[idx];
  const float t1 = s_tau[idx + 1];
  const float z0 = z_levels[idx];
  const float z1 = z_levels[idx + 1];
  const float width = fmaxf(__fsub_rn(t1, t0), 1e-30f);
  const float frac =
      fminf(fmaxf(__fdiv_rn(__fsub_rn(q, t0), width), 0.0f), 1.0f);
  z_out[b] = __fadd_rn(z0, __fmul_rn(frac, __fsub_rn(z1, z0)));
  layer_out[b] = idx;
  for (int k = 0; k < K; ++k) {
    fetched_out[static_cast<size_t>(k) * B + b] =
        tables[static_cast<size_t>(k) * L + idx];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int collision_fetch_launch(const float* tau_q, const float* z_levels,
                                      const float* tau_levels,
                                      const float* tables, float* z_out,
                                      int* layer_out, float* fetched_out, int B,
                                      int L, int K, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(L + 1) * sizeof(float);
  collision_fetch_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      tau_q, z_levels, tau_levels, tables, z_out, layer_out, fetched_out, B, L,
      K);
  return static_cast<int>(cudaGetLastError());
}
