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
// across chunks and instances the first wins. Misses keep t = t_max and the
// normal (0, 0, 1).
//
// Design: one thread per ray, 128 rays per block. Leaves come in groups of
// 128 consecutive (Morton-ordered) leaves, each with a bounding sphere
// (spheres row 1 + g; row 0 bounds the whole table and serves as the
// per-instance sphere). A block stages a group in shared memory (9 floats
// per leaf, 4.5 KB) when __syncthreads_or says any of its rays can reach the
// group's sphere within its current cap; each thread tests only groups it
// reaches itself. The nearest sweep keeps its best t as the running cap, so
// later spheres cull against it; the any-hit sweep retires a ray at its
// first hit. Inside a group a ray first asks whether its line passes within
// the disk's radius of the disk's centre (no division), and only then runs
// the exact test. Both culls are conservative: the group sphere's radius^2
// is inflated by 1e-4 relative, and both tests by a margin that scales with
// the magnitude of the coordinates, several times what float32 rounding can
// move either, so no cull drops a disk the dense sweep would hit. The library
// is built with -fmad=false; the fused multiply-adds of the exact test are
// written out (__fmaf_rn) where the reference has them and nowhere else,
// and the plain versions round the same way, so kernels and plain versions
// agree bit for bit.
//
// What bounds it on this card: the leaf table is a few tens of KB and stays
// in L2, each ray moves 28 bytes in and 17 (nearest) or 1 (any hit) out,
// and each exact disk test is ~30 float32 operations with one division: the
// sweep is bound by operations, and by how many groups the culls leave.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 128;   // leaves per bounding sphere (GROUP)
constexpr int kChunk = 512;   // leaves per tie-averaging chunk (CHUNK)
constexpr float kEpsT = 1e-7f;
constexpr float kDnMin = 1e-12f;
constexpr float kCullSlack = 1.0001f;
constexpr float kLineSlack = 2e-6f;  // ~8 float32 ulp of the distance to a disk

// a * b + c rounded once, as the reference's contracted products and sums.
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return fma_rn(az, bz, fma_rn(ay, by, ax * bx));
}

struct Ray {
  float px, py, pz, dx, dy, dz;
  float l1;  // |px| + |py| + |pz|: the scale of the exact test's rounding
};

__device__ __forceinline__ Ray make_ray(float px, float py, float pz, float dx,
                                        float dy, float dz) {
  return Ray{px, py, pz, dx, dy, dz, fabsf(px) + fabsf(py) + fabsf(pz)};
}

// One staged group: SoA rows cx cy cz nx ny nz r2 cn r.
struct Group {
  float v[9][kGroup];
};

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

// Does the ray's line pass within the disk's radius of its centre? A disk
// that is hit lies wholly within that distance, so a line that fails cannot
// hit it. The margin covers the rounding of this test and of the exact test
// (whose q = p + d t carries an error that scales with |p| and t <= |v| + r),
// so that a disk the exact test would pass is never dropped. Directions are
// unit vectors, as for sphere_cull.
__device__ __forceinline__ bool line_near(const Ray& r, const Group& g, int k) {
  const float vx = g.v[0][k] - r.px, vy = g.v[1][k] - r.py, vz = g.v[2][k] - r.pz;
  const float tc = __fmaf_rn(r.dz, vz, __fmaf_rn(r.dy, vy, r.dx * vx));
  const float ex = __fmaf_rn(-r.dx, tc, vx);
  const float ey = __fmaf_rn(-r.dy, tc, vy);
  const float ez = __fmaf_rn(-r.dz, tc, vz);
  const float rr = g.v[8][k];
  const float reach =
      rr + kLineSlack * (fabsf(vx) + fabsf(vy) + fabsf(vz) + r.l1 + rr);
  return __fmaf_rn(ez, ez, __fmaf_rn(ey, ey, ex * ex)) <= reach * reach;
}

// Intersection distance of the ray with staged leaf k, or a negative number
// where it misses (t_max is the strict upper gate).
__device__ __forceinline__ float disk_hit(const Ray& r, float t_max,
                                          const Group& g, int k) {
  if (!line_near(r, g, k)) return -1.0f;
  const float nx = g.v[3][k], ny = g.v[4][k], nz = g.v[5][k];
  const float dn = dot3(r.dx, r.dy, r.dz, nx, ny, nz);
  const bool live = fabsf(dn) > kDnMin;
  const float pn = dot3(r.px, r.py, r.pz, nx, ny, nz);
  const float t = (g.v[7][k] - pn) / (live ? dn : kDnMin);
  const float qx = fma_rn(r.dx, t, r.px) - g.v[0][k];
  const float qy = fma_rn(r.dy, t, r.py) - g.v[1][k];
  const float qz = fma_rn(r.dz, t, r.pz) - g.v[2][k];
  const float dist2 = dot3(qx, qy, qz, qx, qy, qz);
  const bool ok = (t > kEpsT) && (t < t_max) && (dist2 <= g.v[6][k]) && live;
  return ok ? t : -1.0f;
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

// Running nearest hit with the reference's tie rule.
struct Best {
  float t;        // running cap: t_max until a hit is found
  float nx, ny, nz;
  int count;      // tied leaves summed into (nx, ny, nz)
  int chunk;      // (instance, 512-leaf chunk) id of the winner, -1 = none
};

// Sweep one table (one instance frame) for the nearest hit. Every thread of
// the block calls this together; `active` threads take part in the tests.
__device__ __forceinline__ void sweep_nearest(const Ray& r, bool active, Best& best,
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
        const float t = disk_hit(r, 3.0e38f, g, k);
        if (t < 0.0f) continue;
        if (t < best.t) {
          best.t = t;
          best.nx = g.v[3][k]; best.ny = g.v[4][k]; best.nz = g.v[5][k];
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

// Sweep one table for any hit; returns with `occluded` set where found.
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
        if (disk_hit(r, t_max, g, k) >= 0.0f) {
          occluded = true;
          break;
        }
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ p,
                                        const float* __restrict__ d, int b) {
  return make_ray(p[3 * b], p[3 * b + 1], p[3 * b + 2], d[3 * b], d[3 * b + 1],
                  d[3 * b + 2]);
}

__device__ __forceinline__ void store_nearest(const Best& best, float t_max, int b,
                                              float* __restrict__ t_hit,
                                              float* __restrict__ normal,
                                              bool* __restrict__ hit) {
  const bool found = best.chunk >= 0;
  const float cnt = static_cast<float>(max(best.count, 1));
  t_hit[b] = found ? best.t : t_max;
  normal[3 * b] = found ? best.nx / cnt : 0.0f;
  normal[3 * b + 1] = found ? best.ny / cnt : 0.0f;
  normal[3 * b + 2] = found ? best.nz / cnt : 1.0f;
  hit[b] = found;
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
  Best best{tm, 0.0f, 0.0f, 1.0f, 0, -1};
  const int chunks = (N + kChunk - 1) / kChunk;

  if (offsets == nullptr) {
    sweep_nearest(r0, active, best, g, centers, normals, radii, spheres, N, 0);
  } else {
    for (int i = 0; i < I; ++i) {
      const Ray r = make_ray(r0.px - offsets[3 * i], r0.py - offsets[3 * i + 1],
                             r0.pz - offsets[3 * i + 2], r0.dx, r0.dy, r0.dz);
      const bool reach = active && sphere_cull(r, best.t, spheres);
      if (!__syncthreads_or(reach)) continue;
      sweep_nearest(r, reach, best, g, centers, normals, radii, spheres, N, i * chunks);
    }
  }
  if (in_range) store_nearest(best, tm, b, t_hit, normal, hit);
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

  if (offsets == nullptr) {
    sweep_occluded(r0, tm, active, occluded, g, centers, normals, radii, spheres, N);
  } else {
    for (int i = 0; i < I; ++i) {
      const Ray r = make_ray(r0.px - offsets[3 * i], r0.py - offsets[3 * i + 1],
                             r0.pz - offsets[3 * i + 2], r0.dx, r0.dy, r0.dz);
      const bool reach = active && !occluded && sphere_cull(r, tm, spheres);
      if (!__syncthreads_or(reach)) continue;
      sweep_occluded(r, tm, reach, occluded, g, centers, normals, radii, spheres, N);
    }
  }
  if (in_range) occ[b] = occluded;
}

int launch_nearest(const float* p, const float* d, const float* t_max,
                   const float* centers, const float* normals, const float* radii,
                   const float* spheres, const float* offsets, float* t_hit,
                   float* normal, bool* hit, int B, int N, int I, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  nearest_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, centers, normals, radii, spheres, offsets, t_hit, normal, hit, B, N, I);
  return static_cast<int>(cudaGetLastError());
}

int launch_occluded(const float* p, const float* d, const float* t_max,
                    const float* centers, const float* normals, const float* radii,
                    const float* spheres, const float* offsets, bool* occ, int B,
                    int N, int I, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  occluded_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, centers, normals, radii, spheres, offsets, occ, B, N, I);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 = launched).
extern "C" int ray_leaves_nearest_launch(const float* p, const float* d,
                                         const float* t_max, const float* centers,
                                         const float* normals, const float* radii,
                                         const float* spheres, float* t_hit,
                                         float* normal, bool* hit, int B, int N,
                                         void* stream) {
  return launch_nearest(p, d, t_max, centers, normals, radii, spheres, nullptr, t_hit,
                        normal, hit, B, N, 1, stream);
}

extern "C" int ray_leaves_occluded_launch(const float* p, const float* d,
                                          const float* t_max, const float* centers,
                                          const float* normals, const float* radii,
                                          const float* spheres, bool* occ, int B,
                                          int N, void* stream) {
  return launch_occluded(p, d, t_max, centers, normals, radii, spheres, nullptr, occ, B,
                         N, 1, stream);
}

extern "C" int ray_leaves_nearest_instanced_launch(
    const float* p, const float* d, const float* t_max, const float* centers,
    const float* normals, const float* radii, const float* spheres,
    const float* offsets, float* t_hit, float* normal, bool* hit, int B, int N, int I,
    void* stream) {
  return launch_nearest(p, d, t_max, centers, normals, radii, spheres, offsets, t_hit,
                        normal, hit, B, N, I, stream);
}

extern "C" int ray_leaves_occluded_instanced_launch(
    const float* p, const float* d, const float* t_max, const float* centers,
    const float* normals, const float* radii, const float* spheres,
    const float* offsets, bool* occ, int B, int N, int I, void* stream) {
  return launch_occluded(p, d, t_max, centers, normals, radii, spheres, offsets, occ, B,
                         N, I, stream);
}
