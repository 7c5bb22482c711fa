// Floors of the two collision-fetch designs, for tools/chip_fetch_turns.py.
//
// Each kernel keeps one design's launch, staging and memory traffic and
// takes out the search and the fetch: a lane loads tau_q and stores it as z,
// and stores constants as its layer and its K fetched values. What a design
// takes above its floor is its search and fetch; what the floor takes above
// the bytes bound is its launch, staging and memory access.
//
// * parent_floor: one lane a thread in blocks of 256, each block staging the
//   L + 1 levels behind a barrier (eradiate_tpu_torch/csrc/collision_fetch.cu
//   before its redesign).
// * redesign_floor: four lanes a thread in blocks of 256, read and written
//   as 16-byte values, each block staging its breadth-first search tree
//   (2^T floats) behind a barrier (the redesign); a lane at a time where
//   tau_q is not 16-byte aligned, and for the ragged tail.
//
// Build (the script does): nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -shared -Xcompiler -fPIC -o libfetch_floors.so fetch_floors.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void parent_floor_kernel(const float* __restrict__ tau_q,
                                    const float* __restrict__ tau_levels, float* __restrict__ z,
                                    int* __restrict__ layer, float* __restrict__ fetched, int B,
                                    int L, int K) {
  extern __shared__ float s_tau[];
  for (int i = threadIdx.x; i <= L; i += blockDim.x) s_tau[i] = tau_levels[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  z[b] = tau_q[b];
  layer[b] = __float_as_int(s_tau[0]);  // 0: keeps the staging
  for (int k = 0; k < K; ++k) fetched[static_cast<size_t>(k) * B + b] = 0.0f;
}

__global__ void __launch_bounds__(256, 5)
redesign_floor_kernel(const float* __restrict__ tau_q, const float* __restrict__ tau_levels,
                      float* __restrict__ z, int* __restrict__ layer,
                      float* __restrict__ fetched, int B, int L, int K, int T, bool vec) {
  extern __shared__ float tree[];
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long quads = vec ? B / 4 : 0;
  float4 qv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (t < quads) qv = __ldg(reinterpret_cast<const float4*>(tau_q) + t);
  for (int i = threadIdx.x; i < (1 << T); i += blockDim.x) {
    float v = __int_as_float(0x7f800000);
    if (i > 0) {
      const int d = 31 - __clz(i);
      const int s = ((2 * (i - (1 << d)) + 1) << (T - 1 - d)) - 1;
      if (s <= L) v = __ldg(tau_levels + s);
    }
    tree[i] = v;
  }
  __syncthreads();
  const int zero = __float_as_int(tree[0]) & 0;  // 0: keeps the staging
  if (t < quads) {
    reinterpret_cast<float4*>(z)[t] = qv;
    reinterpret_cast<int4*>(layer)[t] = make_int4(zero, zero, zero, zero);
    for (int k = 0; k < K; ++k) {
      float* row = fetched + static_cast<size_t>(k) * B + 4 * t;
      if (B % 4 == 0) {
        *reinterpret_cast<float4*>(row) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        for (int j = 0; j < 4; ++j) row[j] = 0.0f;
      }
    }
  }
  const long long b = 4 * quads + t;
  if (b < B) {
    z[b] = __ldg(tau_q + b);
    layer[b] = zero;
    for (int k = 0; k < K; ++k) fetched[static_cast<size_t>(k) * B + b] = 0.0f;
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int parent_floor_launch(const float* tau_q, const float* tau_levels, float* z,
                                   int* layer, float* fetched, int B, int L, int K,
                                   void* stream) {
  parent_floor_kernel<<<(B + 255) / 256, 256, (L + 1) * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(tau_q, tau_levels, z, layer,
                                                             fetched, B, L, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int redesign_floor_launch(const float* tau_q, const float* tau_levels, float* z,
                                     int* layer, float* fetched, int B, int L, int K,
                                     void* stream) {
  int T = 0;
  while ((1 << T) < L + 2) ++T;
  const size_t bytes = sizeof(float) << T;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        redesign_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  const bool vec = aligned(tau_q) && aligned(z) && aligned(layer) && aligned(fetched);
  const long long quads = vec ? B / 4 : 0;
  const long long threads = quads > B - 4 * quads ? quads : B - 4 * quads;
  redesign_floor_kernel<<<static_cast<int>((threads + 255) / 256), 256, bytes,
                          static_cast<cudaStream_t>(stream)>>>(tau_q, tau_levels, z, layer,
                                                               fetched, B, L, K, T, vec);
  return static_cast<int>(cudaGetLastError());
}
