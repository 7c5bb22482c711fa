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
// The float64 builds (the double modes: *_f64 below) run the same walks
// over the same float32 hierarchy, one thread per ray, with float64 rays,
// disks (three double4 a disk, (c, original index's int64 bits), (n, r),
// (r^2, c.n)) and exact tests (__fma_rn, the IEEE float64 division), the
// box tests on the ray rounded to float32 (bvh.cuh box_ray, cull_cap).
// They replace the same TPU kernels, which take float32 only; the
// reference renders its double modes through its XLA sweeps, whose float64
// arithmetic they reproduce. Tied float64 normals do not sum exactly: two
// sum alike in either order, and where three or more tie, the nearest-hit
// kernels sum them again after the walk in index order from zero (the
// reference's masked sum), testing the winning 512-disk chunk's disks
// (and, instanced, the winning instance's) in the table's original order.
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

// ---------------------------------------------------------------------------
// The float64 builds.

constexpr double kDnMin64 = 1e-12;
constexpr double kEpsT64 = 1e-7;
constexpr double kLineSlack64 = 2e-6;  // the float32 margin: ~1e10 float64 ulp

struct Disk64 {
  double cx, cy, cz, nx, ny, nz, r2, cn, r;
};

// line_near in float64 (a cull only: its margin dwarfs float64 rounding).
__device__ __forceinline__ bool line_near64(const Ray64& r, const Disk64& q) {
  const double vx = q.cx - r.px, vy = q.cy - r.py, vz = q.cz - r.pz;
  const double tc = __fma_rn(r.dz, vz, __fma_rn(r.dy, vy, r.dx * vx));
  const double ex = __fma_rn(-r.dx, tc, vx);
  const double ey = __fma_rn(-r.dy, tc, vy);
  const double ez = __fma_rn(-r.dz, tc, vz);
  const double reach =
      q.r + kLineSlack64 * (fabs(vx) + fabs(vy) + fabs(vz) + r.l1 + q.r);
  return __fma_rn(ez, ez, __fma_rn(ey, ey, ex * ex)) <= reach * reach;
}

__device__ __forceinline__ double dot3_64(double ax, double ay, double az, double bx,
                                          double by, double bz) {
  return __fma_rn(az, bz, __fma_rn(ay, by, ax * bx));
}

// disk_hit in float64: the same test, rounded as the reference under x64.
__device__ __forceinline__ double disk_hit64(const Ray64& r, double t_max, const Disk64& q) {
  if (!line_near64(r, q)) return -1.0;
  const double dn = dot3_64(r.dx, r.dy, r.dz, q.nx, q.ny, q.nz);
  const bool live = fabs(dn) > kDnMin64;
  const double pn = dot3_64(r.px, r.py, r.pz, q.nx, q.ny, q.nz);
  const double t = (q.cn - pn) / (live ? dn : kDnMin64);
  const double qx = __fma_rn(r.dx, t, r.px) - q.cx;
  const double qy = __fma_rn(r.dy, t, r.py) - q.cy;
  const double qz = __fma_rn(r.dz, t, r.pz) - q.cz;
  const double dist2 = dot3_64(qx, qy, qz, qx, qy, qz);
  const bool ok = (t > kEpsT64) && (t < t_max) && (dist2 <= q.r2) && live;
  return ok ? t : -1.0;
}

// Disk row k of a float64 hierarchy's table (six double2), and its index.
__device__ __forceinline__ Disk64 load_disk64(const double2* __restrict__ disks, int k,
                                              int& index) {
  const double2 a = __ldg(disks + 6 * k);
  const double2 b = __ldg(disks + 6 * k + 1);
  const double2 n = __ldg(disks + 6 * k + 2);
  const double2 m = __ldg(disks + 6 * k + 3);
  const double2 e = __ldg(disks + 6 * k + 4);
  index = static_cast<int>(__double_as_longlong(b.y));
  return Disk64{a.x, a.y, b.x, n.x, n.y, m.x, e.x, e.y, m.y};
}

// Disk `i` of the table in its original order, c.n and r^2 rounded as the
// host rounds them into the hierarchy's rows (plain products and sums).
__device__ __forceinline__ Disk64 original_disk64(const double* __restrict__ c,
                                                  const double* __restrict__ n,
                                                  const double* __restrict__ rad, int i) {
  Disk64 q;
  q.cx = c[3 * i]; q.cy = c[3 * i + 1]; q.cz = c[3 * i + 2];
  q.nx = n[3 * i]; q.ny = n[3 * i + 1]; q.nz = n[3 * i + 2];
  q.r = rad[i];
  q.r2 = q.r * q.r;
  q.cn = (q.cx * q.nx + q.cy * q.ny) + q.cz * q.nz;
  return q;
}

// Three or more tied normals: sum them again from zero in index order over
// 512-disk chunk `chunk` of the table (the reference's masked sum).
__device__ __forceinline__ void resum_ties(Best64& best, const Ray64& r, double tm, int chunk,
                                           const double* __restrict__ c,
                                           const double* __restrict__ n,
                                           const double* __restrict__ rad, int N) {
  if (best.count < 3) return;
  double sx = 0.0, sy = 0.0, sz = 0.0;
  int count = 0;
  const int end = min(N, (chunk + 1) * kChunk);
  for (int i = chunk * kChunk; i < end; ++i) {
    const Disk64 q = original_disk64(c, n, rad, i);
    if (disk_hit64(r, tm, q) == best.t) {
      sx += q.nx; sy += q.ny; sz += q.nz;
      ++count;
    }
  }
  best.sx = sx; best.sy = sy; best.sz = sz;
  best.count = count;
}

__global__ void __launch_bounds__(kThreads)
leaf_bvh_nearest_f64_kernel(const double* __restrict__ p, const double* __restrict__ d,
                            const double* __restrict__ t_max,
                            const float4* __restrict__ nodes,
                            const double2* __restrict__ disks,
                            const double* __restrict__ centers,
                            const double* __restrict__ normals,
                            const double* __restrict__ radii, double* __restrict__ t_hit,
                            double* __restrict__ normal, bool* __restrict__ hit, int B, int N) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Ray64 r = load_ray64(p, d, b);
  const double tm = t_max[b];
  Best64 best{tm, 0.0, 0.0, 1.0, 0, kNoChunk};
  if (tm > kEpsT64) {
    traverse(box_ray(r), best.t, nodes, [&](int first, int end) {
      for (int k = first; k < end; ++k) {
        int index;
        const Disk64 q = load_disk64(disks, k, index);
        best.take(disk_hit64(r, tm, q), index / kChunk, [&](double& nx, double& ny, double& nz) {
          nx = q.nx;
          ny = q.ny;
          nz = q.nz;
        });
      }
      return false;
    });
    resum_ties(best, r, tm, best.chunk, centers, normals, radii, N);
  }
  store_nearest64(best, tm, b, t_hit, normal, hit);
}

__global__ void __launch_bounds__(kThreads)
leaf_bvh_occluded_f64_kernel(const double* __restrict__ p, const double* __restrict__ d,
                             const double* __restrict__ t_max,
                             const float4* __restrict__ nodes,
                             const double2* __restrict__ disks, bool* __restrict__ occ, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Ray64 r = load_ray64(p, d, b);
  const double tm = t_max[b];
  bool occluded = false;
  if (tm > kEpsT64) {
    traverse(box_ray(r), tm, nodes, [&](int first, int end) {
      for (int k = first; k < end && !occluded; ++k) {
        int index;
        occluded = disk_hit64(r, tm, load_disk64(disks, k, index)) >= 0.0;
      }
      return occluded;
    });
  }
  occ[b] = occluded;
}

__global__ void __launch_bounds__(kThreads)
leaf_ibvh_nearest_f64_kernel(const double* __restrict__ p, const double* __restrict__ d,
                             const double* __restrict__ t_max, const float4* __restrict__ top,
                             const double2* __restrict__ instances,
                             const float4* __restrict__ nodes,
                             const double2* __restrict__ disks,
                             const double* __restrict__ centers,
                             const double* __restrict__ normals,
                             const double* __restrict__ radii,
                             const double* __restrict__ offsets, double* __restrict__ t_hit,
                             double* __restrict__ normal, bool* __restrict__ hit, int B,
                             int N) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Ray64 r = load_ray64(p, d, b);
  const double tm = t_max[b];
  const int chunks = (N + kChunk - 1) / kChunk;
  Best64 best{tm, 0.0, 0.0, 1.0, 0, kNoChunk};
  if (tm > kEpsT64) {
    traverse_instances64(r, best.t, top, instances, nodes,
                         [&](const Ray64& ri, int row, int first, int end) {
      for (int k = first; k < end; ++k) {
        int index;
        const Disk64 q = load_disk64(disks, k, index);
        best.take(disk_hit64(ri, tm, q), row * chunks + index / kChunk,
                  [&](double& nx, double& ny, double& nz) {
                    nx = q.nx;
                    ny = q.ny;
                    nz = q.nz;
                  });
      }
      return false;
    });
    if (best.count >= 3) {
      // the winner's instance frame, the ray translated as the walk did
      const int row = best.chunk / chunks;
      const Ray64 ri = make_ray64(r.px - offsets[3 * row], r.py - offsets[3 * row + 1],
                                  r.pz - offsets[3 * row + 2], r.dx, r.dy, r.dz);
      resum_ties(best, ri, tm, best.chunk % chunks, centers, normals, radii, N);
    }
  }
  store_nearest64(best, tm, b, t_hit, normal, hit);
}

__global__ void __launch_bounds__(kThreads)
leaf_ibvh_occluded_f64_kernel(const double* __restrict__ p, const double* __restrict__ d,
                              const double* __restrict__ t_max, const float4* __restrict__ top,
                              const double2* __restrict__ instances,
                              const float4* __restrict__ nodes,
                              const double2* __restrict__ disks, bool* __restrict__ occ,
                              int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Ray64 r = load_ray64(p, d, b);
  const double tm = t_max[b];
  bool occluded = false;
  if (tm > kEpsT64) {
    traverse_instances64(r, tm, top, instances, nodes,
                         [&](const Ray64& ri, int, int first, int end) {
      for (int k = first; k < end && !occluded; ++k) {
        int index;
        occluded = disk_hit64(ri, tm, load_disk64(disks, k, index)) >= 0.0;
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

// The float64 builds: float64 rays, outputs and tables (leaf_bvh and
// leaf_instanced_bvh of float64 disks; the nodes stay float32). The nearest
// hits also take the table (and the offsets) in their original order, where
// they sum three or more tied normals; N is the disk count.
extern "C" int ray_leaves_nearest_f64_launch(
    const double* p, const double* d, const double* t_max, const float* nodes,
    const double* disks, const double* centers, const double* normals, const double* radii,
    double* t_hit, double* normal, bool* hit, int B, int N, void* stream) {
  leaf_bvh_nearest_f64_kernel<<<blocks_for(B), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const double2*>(disks), centers, normals, radii, t_hit, normal, hit, B,
      N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_leaves_occluded_f64_launch(const double* p, const double* d,
                                              const double* t_max, const float* nodes,
                                              const double* disks, bool* occ, int B,
                                              void* stream) {
  leaf_bvh_occluded_f64_kernel<<<blocks_for(B), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const double2*>(disks), occ, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_leaves_nearest_instanced_f64_launch(
    const double* p, const double* d, const double* t_max, const float* top,
    const double* instances, const float* nodes, const double* disks, const double* centers,
    const double* normals, const double* radii, const double* offsets, double* t_hit,
    double* normal, bool* hit, int B, int N, void* stream) {
  leaf_ibvh_nearest_f64_kernel<<<blocks_for(B), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(top),
      reinterpret_cast<const double2*>(instances), reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const double2*>(disks), centers, normals, radii, offsets, t_hit, normal,
      hit, B, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_leaves_occluded_instanced_f64_launch(
    const double* p, const double* d, const double* t_max, const float* top,
    const double* instances, const float* nodes, const double* disks, bool* occ, int B,
    void* stream) {
  leaf_ibvh_occluded_f64_kernel<<<blocks_for(B), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(top),
      reinterpret_cast<const double2*>(instances), reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const double2*>(disks), occ, B);
  return static_cast<int>(cudaGetLastError());
}
