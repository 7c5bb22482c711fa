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
// at the top level and runs of equal levels go to the upper bound, and a NaN
// query past every level (layer L - 1, z NaN), as
// torch.searchsorted(right=True) and the twin's NaN-propagating clamp do.
//
// What bounds it on this card: bytes. A lane reads tau_q and writes z, its
// layer and K fetched values: (K + 3) * 4 bytes, 24 at c1's K = 3, so the
// path's 2^21 lanes move 50 MB a launch, 0.015 ms at 3.35 TB/s. The tables
// (L + 1 levels, K rows of L) are a few KB and stay in L1 and L2. The design
// keeps the memory traffic at those bytes, in 16-byte accesses, and the
// work of a lane short enough, in registers few enough, that the card keeps
// its loads in flight:
//
// * Four lanes a thread, in blocks of 256: tau_q is read as one 16-byte
//   value (before the block stages its tree, so that the two overlap), and
//   z, the layers and each fetched row are written as 16-byte values.
// * A branch-free search of a fixed trip count T = ceil(log2(L + 2)), the
//   four lanes' searches interleaved, down the levels staged in shared
//   memory as an implicit binary tree in breadth-first order (node i at
//   depth d holds sorted level (2 (i - 2^d) + 1) 2^(T-1-d) - 1, +inf past
//   the last): the nodes a trip can reach are contiguous, so a warp's first
//   six trips read distinct banks, where a sorted array's power-of-two
//   strides put them in one bank.
// * The bracketing levels and the table rows are read through the
//   read-only cache; the record (t0, w, z0, dz) is rounded with the twin's
//   own operations.
// * A lane at a time where four lanes cannot be read or written as one
//   value: a tau_q that is not 16-byte aligned (a q[1:] view), and the
//   ragged tail; where B % 4 != 0 the rows of `fetched` (row k starts at
//   k * B) are written a value at a time.
//
// Measured against a persistent grid of resident blocks (with and without
// the records and rows staged in shared memory, and with the queries
// brought in by cp.async), this shape was the fastest: the per-lane work
// overlaps the memory traffic only with enough warps resident, so the
// launch bounds hold the kernel to 48 registers, five blocks an SM
// (PERF.md §6).
//
// The arithmetic is written with round-to-nearest intrinsics so that nvcc
// cannot contract it into an FMA: the kernel equals its plain PyTorch twin on
// the card bit for bit.
//
// The double modes take a float64 build of their own,
// collision_fetch_f64_kernel: the same search, tree and record in float64,
// one lane a thread (no 16-byte quads: the first float64 build is the
// simple one). Its tree of 2^T doubles needs twice the shared memory, 128
// KiB at MAX_LEVELS = 12288 (T = 14), within the 227 KiB a block may take.
// It reads 8 bytes and writes (K + 1) * 8 + 4 a lane, 44 at c1's K = 3.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Blocks an SM must hold: caps the registers at 48 a thread.
constexpr int kMinBlocks = 5;

// Trips of the search at L layers: the least T with 2^T >= L + 2 outcomes.
int search_trips(int L) {
  int T = 0;
  while ((1 << T) < L + 2) ++T;
  return T;
}

template <typename R>
struct ColumnT {
  const R* z_levels;    // [L + 1]
  const R* tau_levels;  // [L + 1], ascending
  const R* tables;      // [K, L]
  int L, K, T;
};
using Column = ColumnT<float>;
using Column64 = ColumnT<double>;

// z at query q inside layer i, rounded as the twin rounds it; the clamp
// keeps a NaN.
__device__ __forceinline__ float interpolate(const Column& c, float q, int i) {
  const float t0 = __ldg(c.tau_levels + i);
  const float t1 = __ldg(c.tau_levels + i + 1);
  const float z0 = __ldg(c.z_levels + i);
  const float z1 = __ldg(c.z_levels + i + 1);
  float frac = __fdiv_rn(__fsub_rn(q, t0), fmaxf(__fsub_rn(t1, t0), 1e-30f));
  if (frac == frac) frac = fminf(fmaxf(frac, 0.0f), 1.0f);  // a NaN is kept
  return __fadd_rn(z0, __fmul_rn(frac, __fsub_rn(z1, z0)));
}

// z at query q inside layer i in float64, rounded as the twin rounds it.
__device__ __forceinline__ double interpolate(const Column64& c, double q, int i) {
  const double t0 = __ldg(c.tau_levels + i);
  const double t1 = __ldg(c.tau_levels + i + 1);
  const double z0 = __ldg(c.z_levels + i);
  const double z1 = __ldg(c.z_levels + i + 1);
  double frac = __ddiv_rn(__dsub_rn(q, t0), fmax(__dsub_rn(t1, t0), 1e-30));
  if (frac == frac) frac = fmin(fmax(frac, 0.0), 1.0);  // a NaN is kept
  return __dadd_rn(z0, __dmul_rn(frac, __dsub_rn(z1, z0)));
}

// N interleaved searches down the tree: each trip goes right where
// !(q < node), so the leaf reached less 2^T counts the levels at or below q
// (a NaN goes right everywhere); the layer is that count less one, clamped.
template <int N, typename R>
__device__ __forceinline__ void search(const R* tree, const ColumnT<R>& c, const R (&q)[N],
                                       int (&layer)[N]) {
  unsigned node[N];
#pragma unroll
  for (int j = 0; j < N; ++j) node[j] = 1;
  for (int t = 0; t < c.T; ++t) {
#pragma unroll
    for (int j = 0; j < N; ++j) node[j] = 2 * node[j] + !(q[j] < tree[node[j]]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    layer[j] = min(max(static_cast<int>(node[j]) - (1 << c.T) - 1, 0), c.L - 1);
  }
}

// Tree node i of the levels in breadth-first order (+inf past the last).
template <typename R>
__device__ __forceinline__ R tree_node(const ColumnT<R>& c, int i) {
  R v = static_cast<R>(__int_as_float(0x7f800000));  // +inf
  if (i > 0) {
    const int d = 31 - __clz(i);
    const int s = ((2 * (i - (1 << d)) + 1) << (c.T - 1 - d)) - 1;
    if (s <= c.L) v = __ldg(c.tau_levels + s);
  }
  return v;
}

// Thread t takes quad t of the lanes where `vec` (queries 16-byte aligned),
// and lane 4 * quads + t a lane at a time: the ragged tail, or every lane.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
collision_fetch_kernel(const float* __restrict__ tau_q, Column c, float* __restrict__ z_out,
                       int* __restrict__ layer_out, float* __restrict__ fetched_out, int B,
                       bool vec) {
  extern __shared__ float tree[];  // 2^T, node 0 unused
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long quads = vec ? B / 4 : 0;
  float4 qv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (t < quads) qv = __ldg(reinterpret_cast<const float4*>(tau_q) + t);

  for (int i = threadIdx.x; i < (1 << c.T); i += blockDim.x) tree[i] = tree_node(c, i);
  __syncthreads();

  if (t < quads) {
    const float q[4] = {qv.x, qv.y, qv.z, qv.w};
    int layer[4];
    search<4>(tree, c, q, layer);
    float z[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) z[j] = interpolate(c, q[j], layer[j]);
    reinterpret_cast<float4*>(z_out)[t] = make_float4(z[0], z[1], z[2], z[3]);
    reinterpret_cast<int4*>(layer_out)[t] = make_int4(layer[0], layer[1], layer[2], layer[3]);
    for (int k = 0; k < c.K; ++k) {
      const float* table = c.tables + static_cast<size_t>(k) * c.L;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __ldg(table + layer[j]);
      float* row = fetched_out + static_cast<size_t>(k) * B + 4 * t;
      if (B % 4 == 0) {
        *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) row[j] = v[j];
      }
    }
  }
  const long long b = 4 * quads + t;
  if (b < B) {
    const float q[1] = {__ldg(tau_q + b)};
    int layer[1];
    search<1>(tree, c, q, layer);
    z_out[b] = interpolate(c, q[0], layer[0]);
    layer_out[b] = layer[0];
    for (int k = 0; k < c.K; ++k) {
      fetched_out[static_cast<size_t>(k) * B + b] =
          __ldg(c.tables + static_cast<size_t>(k) * c.L + layer[0]);
    }
  }
}

// The float64 build: one lane a thread.
__global__ void __launch_bounds__(kThreads)
collision_fetch_f64_kernel(const double* __restrict__ tau_q, Column64 c,
                           double* __restrict__ z_out, int* __restrict__ layer_out,
                           double* __restrict__ fetched_out, int B) {
  extern __shared__ double tree64[];  // 2^T, node 0 unused
  for (int i = threadIdx.x; i < (1 << c.T); i += blockDim.x) tree64[i] = tree_node(c, i);
  __syncthreads();
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const double q[1] = {__ldg(tau_q + b)};
  int layer[1];
  search<1>(tree64, c, q, layer);
  z_out[b] = interpolate(c, q[0], layer[0]);
  layer_out[b] = layer[0];
  for (int k = 0; k < c.K; ++k) {
    fetched_out[static_cast<size_t>(k) * B + b] =
        __ldg(c.tables + static_cast<size_t>(k) * c.L + layer[0]);
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Allow a kernel `bytes` of dynamic shared memory (0 = set).
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the next launch reports its own
  return err;
}

}  // namespace

// Launch on `stream`; returns the CUDA error (0 = launched).
extern "C" int collision_fetch_launch(const float* tau_q, const float* z_levels,
                                      const float* tau_levels, const float* tables, float* z_out,
                                      int* layer_out, float* fetched_out, int B, int L, int K,
                                      void* stream) {
  const Column c{z_levels, tau_levels, tables, L, K, search_trips(L)};
  const size_t bytes = sizeof(float) << c.T;
  const cudaError_t err = allow_shared(collision_fetch_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = aligned(tau_q) && aligned(z_out) && aligned(layer_out) && aligned(fetched_out);
  const long long quads = vec ? B / 4 : 0;
  const long long threads = quads > B - 4 * quads ? quads : B - 4 * quads;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  collision_fetch_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      tau_q, c, z_out, layer_out, fetched_out, B, vec);
  return static_cast<int>(cudaGetLastError());
}

// The float64 build; launch on `stream`, returns the CUDA error (0 = launched).
extern "C" int collision_fetch_f64_launch(const double* tau_q, const double* z_levels,
                                          const double* tau_levels, const double* tables,
                                          double* z_out, int* layer_out, double* fetched_out,
                                          int B, int L, int K, void* stream) {
  const Column64 c{z_levels, tau_levels, tables, L, K, search_trips(L)};
  const size_t bytes = sizeof(double) << c.T;
  const cudaError_t err = allow_shared(collision_fetch_f64_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((static_cast<long long>(B) + kThreads - 1) / kThreads);
  collision_fetch_f64_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      tau_q, c, z_out, layer_out, fetched_out, B);
  return static_cast<int>(cudaGetLastError());
}
