// Ray / leaf-disk sweeps for Hopper (sm_90a): nearest hit and any hit of a
// batch of rays against a table of leaf disks, flat or instanced.
//
// Replaces the TPU kernels ray_leaves_nearest_pallas,
// ray_leaves_occluded_pallas and their instanced forms
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
// Flat tables (ray_leaves_nearest, ray_leaves_occluded): one thread per ray,
// 128 rays per block, no shared memory and no block-wide barrier. Each
// thread walks a binary bounding volume hierarchy of the disks' own boxes
// that the host builds once per render (kernels/leaf_intersect.py leaf_bvh;
// the traversal, the box test and the order-free tie rule are bvh.cuh's,
// shared with the flat triangle kernels). A leaf's disks are three float4
// each, (c, original index's bits), (n, r), (r^2, c.n), loaded with __ldg.
// The nearest hit visits the nearer child first and culls boxes against its
// running best t; it sums tied normals in float64, so the result does not
// depend on the visit order; the any hit stops at its first hit. A disk's
// box is c +- r sqrt(1 - n_i^2) on each axis: the point q the exact test
// accepts lies within r of c, off the disk's plane only by the rounding of
// c.n - p.n, and on the ray's line at the computed t (up to the rounding of
// the fused multiply-add), which the box margin covers (bvh.cuh).
//
// Instanced tables: a sweep of sphere-culled groups. Leaves come in groups
// of 128 consecutive (Morton-ordered) leaves, each with a bounding sphere
// (spheres row 1 + g; row 0 bounds the whole table and serves as the
// per-instance sphere). A block stages a group in shared memory (9 floats
// per leaf, 4.5 KB) when __syncthreads_or says any of its rays can reach the
// group's sphere within its current cap; each thread tests only groups it
// reaches itself. The nearest sweep keeps its best t as the running cap, so
// later spheres cull against it; the any-hit sweep retires a ray at its
// first hit. Its sphere cull is conservative: the group sphere's radius^2 is
// inflated by 1e-4 relative, and the test by a margin that scales with the
// magnitude of the coordinates, several times what float32 rounding can
// move it.
//
// In both forms a ray first asks whether its line passes within the disk's
// radius of the disk's centre (no division), and only then runs the exact
// test. The library is built with -fmad=false; the fused multiply-adds of
// the exact test are written out (__fmaf_rn) where the reference has them
// and nowhere else, and the plain versions round the same way, so kernels
// and plain versions agree bit for bit.
//
// What bounds it on this card: the leaf table and its hierarchy are ~2 MB
// and stay in L2, each ray moves 28 bytes in and 17 (nearest) or 1 (any hit)
// out, and each exact disk test is ~30 float32 operations with one
// division, each box test ~45 more: the sweep is bound by the box and disk
// tests its cull leaves a ray.

#include "bvh.cuh"

namespace {

constexpr int kGroup = 128;   // leaves per bounding sphere (GROUP)
constexpr float kDnMin = 1e-12f;
constexpr float kCullSlack = 1.0001f;
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

// ---------------------------------------------------------------------------
// Flat tables: the hierarchy's traversal.

__device__ __forceinline__ Disk load_disk(const float4* __restrict__ disks, int k,
                                          int& index) {
  const float4 a = __ldg(disks + 3 * k);
  const float4 n = __ldg(disks + 3 * k + 1);
  const float4 e = __ldg(disks + 3 * k + 2);
  index = __float_as_int(a.w);
  return Disk{a.x, a.y, a.z, n.x, n.y, n.z, e.x, e.y, n.w};
}

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
// Instanced tables: the sphere-culled staged sweep.

// One staged group: SoA rows cx cy cz nx ny nz r2 cn r.
struct Group {
  float v[9][kGroup];
};

__device__ __forceinline__ Disk staged(const Group& g, int k) {
  return Disk{g.v[0][k], g.v[1][k], g.v[2][k], g.v[3][k], g.v[4][k],
              g.v[5][k], g.v[6][k], g.v[7][k], g.v[8][k]};
}

// Can the segment p + t d, t in [0, cap], reach the sphere (conservative)?
// The point the exact test accepts lies on the segment within a disk's radius
// of its centre, up to the rounding of q = p + d t and of this test: an error
// delta of about kLineSlack times the coordinates' magnitude. A sphere of
// radius R + delta has to be reached; since 2 R delta <= 0.5e-4 R^2 + 2e4
// delta^2, half of the relative slack on R^2 plus 2e4 delta^2 covers it at
// any distance from the origin, and the other half the float32 rounding of
// the sphere itself.
__device__ __forceinline__ bool sphere_cull(const Ray& r, float cap,
                                            const float* __restrict__ s) {
  const float vx = s[0] - r.px, vy = s[1] - r.py, vz = s[2] - r.pz;
  const float tc = fminf(fmaxf(r.dx * vx + r.dy * vy + r.dz * vz, 0.0f), cap);
  const float ex = vx - r.dx * tc, ey = vy - r.dy * tc, ez = vz - r.dz * tc;
  const float delta = kLineSlack * (fabsf(vx) + fabsf(vy) + fabsf(vz) + r.l1);
  return ex * ex + ey * ey + ez * ez <= s[3] * kCullSlack + 2.0001e4f * (delta * delta);
}

__device__ __forceinline__ void stage_group(Group& g,
                                            const float* __restrict__ centers,
                                            const float* __restrict__ normals,
                                            const float* __restrict__ radii,
                                            int first, int count) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    const int i = first + k;
    const float cx = centers[3 * i], cy = centers[3 * i + 1], cz = centers[3 * i + 2];
    const float nx = normals[3 * i], ny = normals[3 * i + 1], nz = normals[3 * i + 2];
    const float rr = radii[i];
    g.v[0][k] = cx; g.v[1][k] = cy; g.v[2][k] = cz;
    g.v[3][k] = nx; g.v[4][k] = ny; g.v[5][k] = nz;
    g.v[6][k] = rr * rr;
    g.v[7][k] = (cx * nx + cy * ny) + cz * nz;
    g.v[8][k] = rr;
  }
}

// Running nearest hit of the instanced sweep, which visits the leaves in
// index order: a leaf wins with a strictly smaller t and ties only inside
// the winner's chunk.
struct SweepBest {
  float t;        // running cap: t_max until a hit is found
  float nx, ny, nz;
  int count;      // tied leaves summed into (nx, ny, nz)
  int chunk;      // (instance, 512-leaf chunk) id of the winner, -1 = none
};

// Sweep one instance frame of the table for the nearest hit. Every thread of
// the block calls this together; `active` threads take part in the tests.
__device__ __forceinline__ void sweep_nearest(const Ray& r, bool active, SweepBest& best,
                                              Group& g,
                                              const float* __restrict__ centers,
                                              const float* __restrict__ normals,
                                              const float* __restrict__ radii,
                                              const float* __restrict__ spheres,
                                              int N, int chunk_base) {
  const int groups = (N + kGroup - 1) / kGroup;
  for (int j = 0; j < groups; ++j) {
    const bool reach = active && sphere_cull(r, best.t, spheres + 4 * (1 + j));
    if (!__syncthreads_or(reach)) continue;
    const int first = j * kGroup;
    const int count = min(kGroup, N - first);
    stage_group(g, centers, normals, radii, first, count);
    __syncthreads();
    if (reach) {
      const int chunk = chunk_base + first / kChunk;
      for (int k = 0; k < count; ++k) {
        // best.t is the gate: t_max until a hit is found, the winner's t
        // after; a leaf wins with a strictly smaller t and ties only inside
        // the winner's chunk
        const float t = disk_hit(r, 3.0e38f, staged(g, k));
        if (t < 0.0f) continue;
        if (t < best.t) {
          best.t = t;
          // summed into zero, as the reference's masked sum: -0.0 becomes +0.0
          best.nx = 0.0f + g.v[3][k]; best.ny = 0.0f + g.v[4][k];
          best.nz = 0.0f + g.v[5][k];
          best.count = 1;
          best.chunk = chunk;
        } else if (t == best.t && chunk == best.chunk) {
          best.nx += g.v[3][k]; best.ny += g.v[4][k]; best.nz += g.v[5][k];
          best.count += 1;
        }
      }
    }
    __syncthreads();
  }
}

// Sweep one instance frame for any hit; returns with `occluded` set where
// found.
__device__ __forceinline__ void sweep_occluded(const Ray& r, float t_max, bool active,
                                               bool& occluded, Group& g,
                                               const float* __restrict__ centers,
                                               const float* __restrict__ normals,
                                               const float* __restrict__ radii,
                                               const float* __restrict__ spheres,
                                               int N) {
  const int groups = (N + kGroup - 1) / kGroup;
  for (int j = 0; j < groups; ++j) {
    const bool reach =
        active && !occluded && sphere_cull(r, t_max, spheres + 4 * (1 + j));
    if (!__syncthreads_or(reach)) continue;
    const int first = j * kGroup;
    const int count = min(kGroup, N - first);
    stage_group(g, centers, normals, radii, first, count);
    __syncthreads();
    if (reach) {
      for (int k = 0; k < count; ++k) {
        if (disk_hit(r, t_max, staged(g, k)) >= 0.0f) {
          occluded = true;
          break;
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
nearest_kernel(const float* __restrict__ p, const float* __restrict__ d,
               const float* __restrict__ t_max, const float* __restrict__ centers,
               const float* __restrict__ normals, const float* __restrict__ radii,
               const float* __restrict__ spheres, const float* __restrict__ offsets,
               float* __restrict__ t_hit, float* __restrict__ normal,
               bool* __restrict__ hit, int B, int N, int I) {
  __shared__ Group g;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = b < B;  // ragged last block: keep the barriers whole
  const Ray r0 = in_range ? load_ray(p, d, b) : make_ray(0, 0, 0, 0, 0, 1);
  const float tm = in_range ? t_max[b] : 0.0f;
  // no t satisfies 1e-7 < t < t_max below this: the lane sweeps nothing
  const bool active = in_range && tm > kEpsT;
  SweepBest best{tm, 0.0f, 0.0f, 1.0f, 0, -1};
  const int chunks = (N + kChunk - 1) / kChunk;
  for (int i = 0; i < I; ++i) {
    const Ray r = make_ray(r0.px - offsets[3 * i], r0.py - offsets[3 * i + 1],
                           r0.pz - offsets[3 * i + 2], r0.dx, r0.dy, r0.dz);
    const bool reach = active && sphere_cull(r, best.t, spheres);
    if (!__syncthreads_or(reach)) continue;
    sweep_nearest(r, reach, best, g, centers, normals, radii, spheres, N, i * chunks);
  }
  if (in_range) {
    const bool found = best.chunk >= 0;
    const float cnt = static_cast<float>(max(best.count, 1));
    t_hit[b] = found ? best.t : tm;
    normal[3 * b] = found ? best.nx / cnt : 0.0f;
    normal[3 * b + 1] = found ? best.ny / cnt : 0.0f;
    normal[3 * b + 2] = found ? best.nz / cnt : 1.0f;
    hit[b] = found;
  }
}

__global__ void __launch_bounds__(kThreads)
occluded_kernel(const float* __restrict__ p, const float* __restrict__ d,
                const float* __restrict__ t_max, const float* __restrict__ centers,
                const float* __restrict__ normals, const float* __restrict__ radii,
                const float* __restrict__ spheres, const float* __restrict__ offsets,
                bool* __restrict__ occ, int B, int N, int I) {
  __shared__ Group g;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = b < B;
  const Ray r0 = in_range ? load_ray(p, d, b) : make_ray(0, 0, 0, 0, 0, 1);
  const float tm = in_range ? t_max[b] : 0.0f;
  const bool active = in_range && tm > kEpsT;
  bool occluded = false;
  for (int i = 0; i < I; ++i) {
    const Ray r = make_ray(r0.px - offsets[3 * i], r0.py - offsets[3 * i + 1],
                           r0.pz - offsets[3 * i + 2], r0.dx, r0.dy, r0.dz);
    const bool reach = active && !occluded && sphere_cull(r, tm, spheres);
    if (!__syncthreads_or(reach)) continue;
    sweep_occluded(r, tm, reach, occluded, g, centers, normals, radii, spheres, N);
  }
  if (in_range) occ[b] = occluded;
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

extern "C" int ray_leaves_nearest_instanced_launch(
    const float* p, const float* d, const float* t_max, const float* centers,
    const float* normals, const float* radii, const float* spheres,
    const float* offsets, float* t_hit, float* normal, bool* hit, int B, int N, int I,
    void* stream) {
  nearest_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, centers, normals, radii, spheres, offsets, t_hit, normal, hit, B, N, I);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_leaves_occluded_instanced_launch(
    const float* p, const float* d, const float* t_max, const float* centers,
    const float* normals, const float* radii, const float* spheres,
    const float* offsets, bool* occ, int B, int N, int I, void* stream) {
  occluded_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, centers, normals, radii, spheres, offsets, occ, B, N, I);
  return static_cast<int>(cudaGetLastError());
}
