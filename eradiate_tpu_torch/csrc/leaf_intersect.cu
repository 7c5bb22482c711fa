// Ray / leaf-disk sweeps for Hopper (sm_90a): nearest hit and any hit of a
// batch of rays against a table of leaf disks, flat or instanced.
//
// Replaces the TPU kernels ray_leaves_nearest_pallas,
// ray_leaves_occluded_pallas and their instanced forms
// ray_leaves_nearest_instanced_pallas and ray_leaves_occluded_instanced_pallas
// (eradiate_tpu/ops/pallas/leaf_intersect.py). They compute what the
// reference's XLA functions compute (ops/canopy.py ray_leaves_nearest,
// ray_leaves_occluded, _instanced_nearest_xla and the instance scan of
// leaf_occluded), exactly as the plain versions in
// eradiate_tpu_torch/kernels/leaf_intersect.py do:
//
//   dn = d.n, pn = p.n     (product, then two fused multiply-adds: dot3)
//   cn = c.n               (plain products and sums)
//   t  = (cn - pn) / (|dn| > 1e-12 ? dn : 1e-12)
//   q  = p + d t           (one fused multiply-add per component)
//   hit where 1e-7 < t < t_max, |q - c|^2 <= r^2 (dot3), |dn| > 1e-12
//
// An instance translates the ray (p - offset), not the leaves. Exact ties
// of t inside one 512-leaf chunk of one instance average their normals;
// across chunks and instances the first wins. The winners' normals are
// summed into a zero, as the reference's masked sum: -0.0 comes out +0.0.
// Misses keep t = t_max and the normal (0, 0, 1).
//
// All four kernels: one thread per ray, 128 rays per block, no shared memory
// and no block-wide barrier. Each thread walks a binary bounding volume
// hierarchy that the host builds once per render, with bvh.cuh's traversal,
// box test and order-free tie rule (shared with the flat triangle kernels).
// A leaf's disks are three float4 each, (c, original index's bits), (n, r),
// (r^2, c.n), loaded with __ldg. The nearest hit visits the nearer child
// first and culls boxes against its running best t; it sums tied normals in
// float64, so the result does not depend on the visit order; the any hit
// stops at its first hit. A disk's box is c +- r sqrt(1 - n_i^2) on each
// axis: the point q the exact test accepts lies within r of c, off the
// disk's plane only by the rounding of c.n - p.n, and on the ray's line at
// the computed t (up to the rounding of the fused multiply-add), which the
// box margin covers (bvh.cuh).
//
// Flat tables (ray_leaves_nearest, ray_leaves_occluded): the hierarchy of
// the disks' own boxes (kernels/leaf_intersect.py leaf_bvh); the tie key is
// the chunk, original index / 512.
//
// Instanced tables (ray_leaves_{nearest,occluded}_instanced): two levels
// (leaf_instanced_bvh, bvh.cuh traverse_instances). The world ray walks a
// small hierarchy of the instances' boxes; at each instance it reaches, the
// ray translated into the instance's frame walks the canonical cloud's
// hierarchy, stored once, with the same running cap, so a hit in a near
// instance culls the boxes of the far ones. The tie key is instance *
// ceil(N / 512) + index / 512, the instance being the offset's original
// row, so that the lower (instance, chunk) wins a tie whatever the order in
// which the walk meets them.
//
// In both forms a ray first asks whether its line passes within the disk's
// radius of the disk's centre (no division), and only then runs the exact
// test. The library is built with -fmad=false; the fused multiply-adds of
// the exact test are written out (__fmaf_rn) where the reference has them
// and nowhere else, and the plain versions round the same way, so kernels
// and plain versions agree bit for bit.
//
// What bounds it on this card: the leaf table and its hierarchy are ~2 MB
// (flat) or ~0.15 MB (instanced) and stay in L2, each ray moves 28 bytes in
// and 17 (nearest) or 1 (any hit) out, and each exact disk test is ~30
// float32 operations with one division, each box test ~45 more: the sweep
// is bound by the box and disk tests its cull leaves a ray, and by the
// divergence of the walks within a warp.

#include "bvh.cuh"

namespace {

constexpr float kDnMin = 1e-12f;
constexpr float kLineSlack = 2e-6f;  // ~8 float32 ulp of the distance to a disk

// One disk: centre, unit normal, radius^2, c.n (plain products and sums), r.
struct Disk {
  float cx, cy, cz, nx, ny, nz, r2, cn, r;
};

// Does the ray's line pass within the disk's radius of its centre? A disk
// that is hit lies wholly within that distance, so a line that fails cannot
// hit it. The margin covers the rounding of this test and of the exact test
// (whose q = p + d t carries an error that scales with |p| and t <= |v| + r),
// so that a disk the exact test would pass is never dropped. Directions are
// unit vectors.
__device__ __forceinline__ bool line_near(const Ray& r, const Disk& q) {
  const float vx = q.cx - r.px, vy = q.cy - r.py, vz = q.cz - r.pz;
  const float tc = __fmaf_rn(r.dz, vz, __fmaf_rn(r.dy, vy, r.dx * vx));
  const float ex = __fmaf_rn(-r.dx, tc, vx);
  const float ey = __fmaf_rn(-r.dy, tc, vy);
  const float ez = __fmaf_rn(-r.dz, tc, vz);
  const float reach =
      q.r + kLineSlack * (fabsf(vx) + fabsf(vy) + fabsf(vz) + r.l1 + q.r);
  return __fmaf_rn(ez, ez, __fmaf_rn(ey, ey, ex * ex)) <= reach * reach;
}

// Intersection distance of the ray with disk q, or a negative number where
// it misses (t_max is the strict upper gate).
__device__ __forceinline__ float disk_hit(const Ray& r, float t_max, const Disk& q) {
  if (!line_near(r, q)) return -1.0f;
  const float dn = dot3(r.dx, r.dy, r.dz, q.nx, q.ny, q.nz);
  const bool live = fabsf(dn) > kDnMin;
  const float pn = dot3(r.px, r.py, r.pz, q.nx, q.ny, q.nz);
  const float t = (q.cn - pn) / (live ? dn : kDnMin);
  const float qx = fma_rn(r.dx, t, r.px) - q.cx;
  const float qy = fma_rn(r.dy, t, r.py) - q.cy;
  const float qz = fma_rn(r.dz, t, r.pz) - q.cz;
  const float dist2 = dot3(qx, qy, qz, qx, qy, qz);
  const bool ok = (t > kEpsT) && (t < t_max) && (dist2 <= q.r2) && live;
  return ok ? t : -1.0f;
}

// Disk row k of a hierarchy's leaf-ordered table, and its original index.
__device__ __forceinline__ Disk load_disk(const float4* __restrict__ disks, int k,
                                          int& index) {
  const float4 a = __ldg(disks + 3 * k);
  const float4 n = __ldg(disks + 3 * k + 1);
  const float4 e = __ldg(disks + 3 * k + 2);
  index = __float_as_int(a.w);
  return Disk{a.x, a.y, a.z, n.x, n.y, n.z, e.x, e.y, n.w};
}

// ---------------------------------------------------------------------------
// Flat tables: the hierarchy's traversal.

__global__ void __launch_bounds__(kThreads)
leaf_bvh_nearest_kernel(const float* __restrict__ p, const float* __restrict__ d,
                        const float* __restrict__ t_max, const float4* __restrict__ nodes,
                        const float4* __restrict__ disks, float* __restrict__ t_hit,
                        float* __restrict__ normal, bool* __restrict__ hit, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Ray r = load_ray(p, d, b);
  const float tm = t_max[b];
  Best best{tm, 0.0, 0.0, 1.0, 0, kNoChunk};
  // no t satisfies 1e-7 < t < t_max below this: the lane visits nothing
  if (tm > kEpsT) {
    traverse(r, best.t, nodes, [&](int first, int end) {
      for (int k = first; k < end; ++k) {
        int index;
        const Disk q = load_disk(disks, k, index);
        best.take(disk_hit(r, tm, q), index / kChunk, [&](float& nx, float& ny, float& nz) {
          nx = q.nx;
          ny = q.ny;
          nz = q.nz;
        });
      }
      return false;
    });
  }
  store_nearest(best, tm, b, t_hit, normal, hit);
}

__global__ void __launch_bounds__(kThreads)
leaf_bvh_occluded_kernel(const float* __restrict__ p, const float* __restrict__ d,
                         const float* __restrict__ t_max, const float4* __restrict__ nodes,
                         const float4* __restrict__ disks, bool* __restrict__ occ, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Ray r = load_ray(p, d, b);
  const float tm = t_max[b];
  bool occluded = false;
  if (tm > kEpsT) {
    traverse(r, tm, nodes, [&](int first, int end) {
      for (int k = first; k < end && !occluded; ++k) {
        int index;
        occluded = disk_hit(r, tm, load_disk(disks, k, index)) >= 0.0f;
      }
      return occluded;
    });
  }
  occ[b] = occluded;
}

// ---------------------------------------------------------------------------
// Instanced tables: the two-level traversal.

__global__ void __launch_bounds__(kThreads)
leaf_ibvh_nearest_kernel(const float* __restrict__ p, const float* __restrict__ d,
                         const float* __restrict__ t_max, const float4* __restrict__ top,
                         const float4* __restrict__ instances,
                         const float4* __restrict__ nodes, const float4* __restrict__ disks,
                         float* __restrict__ t_hit, float* __restrict__ normal,
                         bool* __restrict__ hit, int B, int N) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Ray r = load_ray(p, d, b);
  const float tm = t_max[b];
  const int chunks = (N + kChunk - 1) / kChunk;
  Best best{tm, 0.0, 0.0, 1.0, 0, kNoChunk};
  // no t satisfies 1e-7 < t < t_max below this: the lane visits nothing
  if (tm > kEpsT) {
    traverse_instances(r, best.t, top, instances, nodes,
                       [&](const Ray& ri, int row, int first, int end) {
      for (int k = first; k < end; ++k) {
        int index;
        const Disk q = load_disk(disks, k, index);
        best.take(disk_hit(ri, tm, q), row * chunks + index / kChunk,
                  [&](float& nx, float& ny, float& nz) {
                    nx = q.nx;
                    ny = q.ny;
                    nz = q.nz;
                  });
      }
      return false;
    });
  }
  store_nearest(best, tm, b, t_hit, normal, hit);
}

__global__ void __launch_bounds__(kThreads)
leaf_ibvh_occluded_kernel(const float* __restrict__ p, const float* __restrict__ d,
                          const float* __restrict__ t_max, const float4* __restrict__ top,
                          const float4* __restrict__ instances,
                          const float4* __restrict__ nodes, const float4* __restrict__ disks,
                          bool* __restrict__ occ, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Ray r = load_ray(p, d, b);
  const float tm = t_max[b];
  bool occluded = false;
  if (tm > kEpsT) {
    traverse_instances(r, tm, top, instances, nodes,
                       [&](const Ray& ri, int, int first, int end) {
      for (int k = first; k < end && !occluded; ++k) {
        int index;
        occluded = disk_hit(ri, tm, load_disk(disks, k, index)) >= 0.0f;
      }
      return occluded;
    });
  }
  occ[b] = occluded;
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 = launched). `nodes` and
// `disks` are leaf_bvh's arrays (16-byte aligned).
extern "C" int ray_leaves_nearest_launch(const float* p, const float* d,
                                         const float* t_max, const float* nodes,
                                         const float* disks, float* t_hit, float* normal,
                                         bool* hit, int B, void* stream) {
  leaf_bvh_nearest_kernel<<<blocks_for(B), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(disks), t_hit, normal, hit, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_leaves_occluded_launch(const float* p, const float* d,
                                          const float* t_max, const float* nodes,
                                          const float* disks, bool* occ, int B,
                                          void* stream) {
  leaf_bvh_occluded_kernel<<<blocks_for(B), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(disks), occ, B);
  return static_cast<int>(cudaGetLastError());
}

// `top`, `instances`, `nodes` and `disks` are leaf_instanced_bvh's arrays
// (16-byte aligned); N is the canonical cloud's disk count (the tie key's
// chunks).
extern "C" int ray_leaves_nearest_instanced_launch(
    const float* p, const float* d, const float* t_max, const float* top,
    const float* instances, const float* nodes, const float* disks, float* t_hit,
    float* normal, bool* hit, int B, int N, void* stream) {
  leaf_ibvh_nearest_kernel<<<blocks_for(B), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(top),
      reinterpret_cast<const float4*>(instances), reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(disks), t_hit, normal, hit, B, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_leaves_occluded_instanced_launch(
    const float* p, const float* d, const float* t_max, const float* top,
    const float* instances, const float* nodes, const float* disks, bool* occ, int B,
    void* stream) {
  leaf_ibvh_occluded_kernel<<<blocks_for(B), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(top),
      reinterpret_cast<const float4*>(instances), reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(disks), occ, B);
  return static_cast<int>(cudaGetLastError());
}
