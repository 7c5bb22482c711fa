// Ray / triangle sweeps for Hopper (sm_90a): nearest hit (with the geometric
// normal) and any hit of a batch of rays against a triangle soup, flat or
// instanced.
//
// Replaces the TPU kernels ray_tris_nearest_pallas, ray_tris_occluded_pallas
// and their instanced forms (eradiate_tpu/ops/pallas/tri_intersect.py). They
// compute what the reference's XLA functions compute (ops/mesh.py
// ray_tris_nearest, ray_tris_occluded, _instanced_tris_nearest_xla and the
// instance scan of tri_occluded), exactly as the plain versions in
// eradiate_tpu_torch/kernels/tri_intersect.py do. Triangles are stored
// pre-differenced (v0, e1 = v1 - v0, e2 = v2 - v0), lengths in km:
//
//   pvec = d x e2, qvec = tvec x e1   (each component fma(a_i, b_j, -(a_j b_i)))
//   det  = e1.pvec                    (product, then two fused multiply-adds)
//   inv  = 1 / det where |det| > 1e-12, else no hit
//   tvec = p - v0
//   u = (tvec.pvec) inv               (three products and two sums, unfused)
//   v = (d.qvec) inv,  t = (e2.qvec) inv          (product, then two FMAs)
//   hit where u >= 0, v >= 0, u + v <= 1, 1e-7 < t < t_max
//
// which is how XLA:CPU rounds the jitted reference: a closed fan of triangles
// decides on the last bit whether a ray through a shared edge hits one
// triangle, both or neither. The normal of a hit is cross(e1, e2) / max(norm,
// 1e-12). An instance translates the ray (p - offset), not the triangles.
// Exact ties of t inside one 512-triangle chunk of one instance average their
// unit normals (summed in float64, so the order does not matter; the average
// is not renormalised); across chunks and instances the first wins. Misses
// keep t = t_max and the normal (0, 0, 1). The TPU kernels tie within
// 1024-triangle blocks and normalise with rsqrt; this follows the XLA form.
//
// Design: one thread per ray, 128 rays per block. Triangles come in groups of
// 64 consecutive triangles, each with a bounding sphere over its vertices
// (spheres row 1 + g; row 0 bounds the whole soup and serves as the
// per-instance sphere). A block stages a group in shared memory (9 floats per
// triangle, 2.25 KB) when __syncthreads_or says any of its rays can reach the
// group's sphere within its current cap; each thread tests only groups it
// reaches itself. The nearest sweep keeps its best t as the running cap, so
// later spheres cull against it; the any-hit sweep retires a ray at its first
// hit. The cull is conservative: the sphere's radius^2 is inflated by 1e-4
// relative and by a margin that scales with the magnitude of the coordinates,
// and the segment is lengthened at both ends by 2e-3 of the distance to the
// sphere, which covers the error of the computed t at grazing incidence
// (|det| > 1e-12 admits cosines down to ~1e-4 for metre-sized triangles), so
// no cull drops a triangle the dense sweep would hit. The group size does not
// change the result. The library is built with -fmad=false; the fused
// multiply-adds of the exact test are written out (__fmaf_rn) where the
// reference has them and nowhere else, and the plain versions round the same
// way, so kernels and plain versions agree bit for bit.
//
// What bounds it on this card: the soup is at most a few MB and stays in L2,
// each ray moves 28 bytes in and 17 (nearest) or 1 (any hit) out, and each
// exact test is ~45 float32 operations with one division: the sweep is bound
// by operations, and by how many groups the cull leaves (long thin branches
// fill their spheres badly).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 64;    // triangles per bounding sphere (GROUP)
constexpr int kChunk = 512;   // triangles per tie-averaging chunk (CHUNK)
constexpr float kEpsT = 1e-7f;
constexpr float kDetMin = 1e-12f;
constexpr float kCullSlack = 1.0001f;
constexpr float kLineSlack = 2e-6f;  // ~32 float32 ulp of the coordinates
constexpr float kCapSlack = 2e-3f;   // of the distance to the sphere

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

// One staged group: SoA rows v0x v0y v0z e1x e1y e1z e2x e2y e2z.
struct Group {
  float v[9][kGroup];
};

// Can the segment p + t d, t in [0, cap], reach the sphere (conservative)?
// A triangle the exact test accepts is met by the ray's line within delta,
// the rounding of tvec = p - v0 and of the barycentric products (about
// kLineSlack times the coordinates' magnitude), at a t that the test
// computes with a relative error of up to ~1e-3 at grazing incidence: so the
// segment is lengthened by kCapSlack of the distance at both ends, and a
// sphere of radius R + delta has to be reached; since 2 R delta <= 0.5e-4
// R^2 + 2e4 delta^2, half of the relative slack on R^2 plus 2e4 delta^2
// covers it, and the other half the float32 rounding of the sphere itself.
// Directions are unit vectors.
__device__ __forceinline__ bool sphere_cull(const Ray& r, float cap,
                                            const float* __restrict__ s) {
  const float vx = s[0] - r.px, vy = s[1] - r.py, vz = s[2] - r.pz;
  const float v1 = fabsf(vx) + fabsf(vy) + fabsf(vz);
  const float slack_t = kCapSlack * v1 + 1e-6f;
  const float tc =
      fminf(fmaxf(r.dx * vx + r.dy * vy + r.dz * vz, -slack_t), cap + slack_t);
  const float ex = vx - r.dx * tc, ey = vy - r.dy * tc, ez = vz - r.dz * tc;
  const float delta = kLineSlack * (v1 + r.l1);
  return ex * ex + ey * ey + ez * ez <= s[3] * kCullSlack + 2.0001e4f * (delta * delta);
}

// Moller-Trumbore distance of the ray to staged triangle k, or a negative
// number where it misses (t_max is the strict upper gate).
__device__ __forceinline__ float tri_hit(const Ray& r, float t_max, const Group& g,
                                         int k) {
  const float ax = g.v[3][k], ay = g.v[4][k], az = g.v[5][k];
  const float bx = g.v[6][k], by = g.v[7][k], bz = g.v[8][k];
  const float pvx = fma_rn(r.dy, bz, -(r.dz * by));
  const float pvy = fma_rn(r.dz, bx, -(r.dx * bz));
  const float pvz = fma_rn(r.dx, by, -(r.dy * bx));
  const float det = dot3(ax, ay, az, pvx, pvy, pvz);
  if (!(fabsf(det) > kDetMin)) return -1.0f;
  const float inv = 1.0f / det;
  const float tvx = r.px - g.v[0][k], tvy = r.py - g.v[1][k], tvz = r.pz - g.v[2][k];
  const float u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv;
  if (!(u >= 0.0f)) return -1.0f;
  const float qvx = fma_rn(tvy, az, -(tvz * ay));
  const float qvy = fma_rn(tvz, ax, -(tvx * az));
  const float qvz = fma_rn(tvx, ay, -(tvy * ax));
  const float v = dot3(r.dx, r.dy, r.dz, qvx, qvy, qvz) * inv;
  if (!(v >= 0.0f) || !(u + v <= 1.0f)) return -1.0f;
  const float t = dot3(bx, by, bz, qvx, qvy, qvz) * inv;
  return (t > kEpsT && t < t_max) ? t : -1.0f;
}

// Unit geometric normal of staged triangle k.
__device__ __forceinline__ void tri_normal(const Group& g, int k, float& nx,
                                           float& ny, float& nz) {
  const float ax = g.v[3][k], ay = g.v[4][k], az = g.v[5][k];
  const float bx = g.v[6][k], by = g.v[7][k], bz = g.v[8][k];
  const float cx = fma_rn(ay, bz, -(az * by));
  const float cy = fma_rn(az, bx, -(ax * bz));
  const float cz = fma_rn(ax, by, -(ay * bx));
  const float norm = fmaxf(sqrtf(dot3(cx, cy, cz, cx, cy, cz)), 1e-12f);
  nx = cx / norm;
  ny = cy / norm;
  nz = cz / norm;
}

__device__ __forceinline__ void stage_group(Group& g, const float* __restrict__ v0,
                                            const float* __restrict__ e1,
                                            const float* __restrict__ e2, int first,
                                            int count) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    const int i = first + k;
    g.v[0][k] = v0[3 * i]; g.v[1][k] = v0[3 * i + 1]; g.v[2][k] = v0[3 * i + 2];
    g.v[3][k] = e1[3 * i]; g.v[4][k] = e1[3 * i + 1]; g.v[5][k] = e1[3 * i + 2];
    g.v[6][k] = e2[3 * i]; g.v[7][k] = e2[3 * i + 1]; g.v[8][k] = e2[3 * i + 2];
  }
}

// Running nearest hit with the reference's tie rule.
struct Best {
  float t;            // running cap: t_max until a hit is found
  double sx, sy, sz;  // sum of the tied triangles' unit normals
  int count;          // tied triangles summed
  int chunk;          // (instance, 512-triangle chunk) id of the winner, -1 = none
};

// Sweep one soup (one instance frame) for the nearest hit. Every thread of
// the block calls this together; `active` threads take part in the tests.
__device__ __forceinline__ void sweep_nearest(const Ray& r, bool active, Best& best,
                                              Group& g, const float* __restrict__ v0,
                                              const float* __restrict__ e1,
                                              const float* __restrict__ e2,
                                              const float* __restrict__ spheres, int N,
                                              int chunk_base) {
  const int groups = (N + kGroup - 1) / kGroup;
  for (int j = 0; j < groups; ++j) {
    const bool reach = active && sphere_cull(r, best.t, spheres + 4 * (1 + j));
    if (!__syncthreads_or(reach)) continue;
    const int first = j * kGroup;
    const int count = min(kGroup, N - first);
    stage_group(g, v0, e1, e2, first, count);
    __syncthreads();
    if (reach) {
      const int chunk = chunk_base + first / kChunk;
      for (int k = 0; k < count; ++k) {
        // best.t is the gate: t_max until a hit is found, the winner's t
        // after; a triangle wins with a strictly smaller t and ties only
        // inside the winner's chunk
        const float t = tri_hit(r, 3.0e38f, g, k);
        if (t < 0.0f) continue;
        if (t < best.t) {
          float nx, ny, nz;
          tri_normal(g, k, nx, ny, nz);
          best.t = t;
          // summed into zero, as the reference's masked sum: -0.0 becomes +0.0
          best.sx = 0.0 + nx; best.sy = 0.0 + ny; best.sz = 0.0 + nz;
          best.count = 1;
          best.chunk = chunk;
        } else if (t == best.t && chunk == best.chunk) {
          float nx, ny, nz;
          tri_normal(g, k, nx, ny, nz);
          best.sx += nx; best.sy += ny; best.sz += nz;
          best.count += 1;
        }
      }
    }
    __syncthreads();
  }
}

// Sweep one soup for any hit; returns with `occluded` set where found.
__device__ __forceinline__ void sweep_occluded(const Ray& r, float t_max, bool active,
                                               bool& occluded, Group& g,
                                               const float* __restrict__ v0,
                                               const float* __restrict__ e1,
                                               const float* __restrict__ e2,
                                               const float* __restrict__ spheres,
                                               int N) {
  const int groups = (N + kGroup - 1) / kGroup;
  for (int j = 0; j < groups; ++j) {
    const bool reach =
        active && !occluded && sphere_cull(r, t_max, spheres + 4 * (1 + j));
    if (!__syncthreads_or(reach)) continue;
    const int first = j * kGroup;
    const int count = min(kGroup, N - first);
    stage_group(g, v0, e1, e2, first, count);
    __syncthreads();
    if (reach) {
      for (int k = 0; k < count; ++k) {
        if (tri_hit(r, t_max, g, k) >= 0.0f) {
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

__global__ void __launch_bounds__(kThreads)
tri_nearest_kernel(const float* __restrict__ p, const float* __restrict__ d,
                   const float* __restrict__ t_max, const float* __restrict__ v0,
                   const float* __restrict__ e1, const float* __restrict__ e2,
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
  Best best{tm, 0.0, 0.0, 1.0, 0, -1};
  const int chunks = (N + kChunk - 1) / kChunk;

  if (offsets == nullptr) {
    sweep_nearest(r0, active, best, g, v0, e1, e2, spheres, N, 0);
  } else {
    for (int i = 0; i < I; ++i) {
      const Ray r = make_ray(r0.px - offsets[3 * i], r0.py - offsets[3 * i + 1],
                             r0.pz - offsets[3 * i + 2], r0.dx, r0.dy, r0.dz);
      const bool reach = active && sphere_cull(r, best.t, spheres);
      if (!__syncthreads_or(reach)) continue;
      sweep_nearest(r, reach, best, g, v0, e1, e2, spheres, N, i * chunks);
    }
  }
  if (in_range) {
    const bool found = best.chunk >= 0;
    const float cnt = static_cast<float>(max(best.count, 1));
    t_hit[b] = found ? best.t : tm;
    normal[3 * b] = found ? static_cast<float>(best.sx) / cnt : 0.0f;
    normal[3 * b + 1] = found ? static_cast<float>(best.sy) / cnt : 0.0f;
    normal[3 * b + 2] = found ? static_cast<float>(best.sz) / cnt : 1.0f;
    hit[b] = found;
  }
}

__global__ void __launch_bounds__(kThreads)
tri_occluded_kernel(const float* __restrict__ p, const float* __restrict__ d,
                    const float* __restrict__ t_max, const float* __restrict__ v0,
                    const float* __restrict__ e1, const float* __restrict__ e2,
                    const float* __restrict__ spheres,
                    const float* __restrict__ offsets, bool* __restrict__ occ, int B,
                    int N, int I) {
  __shared__ Group g;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = b < B;
  const Ray r0 = in_range ? load_ray(p, d, b) : make_ray(0, 0, 0, 0, 0, 1);
  const float tm = in_range ? t_max[b] : 0.0f;
  const bool active = in_range && tm > kEpsT;
  bool occluded = false;

  if (offsets == nullptr) {
    sweep_occluded(r0, tm, active, occluded, g, v0, e1, e2, spheres, N);
  } else {
    for (int i = 0; i < I; ++i) {
      const Ray r = make_ray(r0.px - offsets[3 * i], r0.py - offsets[3 * i + 1],
                             r0.pz - offsets[3 * i + 2], r0.dx, r0.dy, r0.dz);
      const bool reach = active && !occluded && sphere_cull(r, tm, spheres);
      if (!__syncthreads_or(reach)) continue;
      sweep_occluded(r, tm, reach, occluded, g, v0, e1, e2, spheres, N);
    }
  }
  if (in_range) occ[b] = occluded;
}

int launch_nearest(const float* p, const float* d, const float* t_max, const float* v0,
                   const float* e1, const float* e2, const float* spheres,
                   const float* offsets, float* t_hit, float* normal, bool* hit, int B,
                   int N, int I, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  tri_nearest_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, v0, e1, e2, spheres, offsets, t_hit, normal, hit, B, N, I);
  return static_cast<int>(cudaGetLastError());
}

int launch_occluded(const float* p, const float* d, const float* t_max, const float* v0,
                    const float* e1, const float* e2, const float* spheres,
                    const float* offsets, bool* occ, int B, int N, int I,
                    void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  tri_occluded_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, v0, e1, e2, spheres, offsets, occ, B, N, I);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 = launched).
extern "C" int ray_tris_nearest_launch(const float* p, const float* d,
                                       const float* t_max, const float* v0,
                                       const float* e1, const float* e2,
                                       const float* spheres, float* t_hit,
                                       float* normal, bool* hit, int B, int N,
                                       void* stream) {
  return launch_nearest(p, d, t_max, v0, e1, e2, spheres, nullptr, t_hit, normal, hit,
                        B, N, 1, stream);
}

extern "C" int ray_tris_occluded_launch(const float* p, const float* d,
                                        const float* t_max, const float* v0,
                                        const float* e1, const float* e2,
                                        const float* spheres, bool* occ, int B, int N,
                                        void* stream) {
  return launch_occluded(p, d, t_max, v0, e1, e2, spheres, nullptr, occ, B, N, 1,
                         stream);
}

extern "C" int ray_tris_nearest_instanced_launch(
    const float* p, const float* d, const float* t_max, const float* v0,
    const float* e1, const float* e2, const float* spheres, const float* offsets,
    float* t_hit, float* normal, bool* hit, int B, int N, int I, void* stream) {
  return launch_nearest(p, d, t_max, v0, e1, e2, spheres, offsets, t_hit, normal, hit,
                        B, N, I, stream);
}

extern "C" int ray_tris_occluded_instanced_launch(
    const float* p, const float* d, const float* t_max, const float* v0,
    const float* e1, const float* e2, const float* spheres, const float* offsets,
    bool* occ, int B, int N, int I, void* stream) {
  return launch_occluded(p, d, t_max, v0, e1, e2, spheres, offsets, occ, B, N, I,
                         stream);
}
