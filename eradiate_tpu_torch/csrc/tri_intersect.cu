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
// The tie rule is written so that it does not depend on the order in which
// triangles are visited: a hit replaces the best when its t is smaller, or
// equal with a lower chunk; it adds its normal when t and chunk are equal.
//
// Flat soups (ray_tris_nearest, ray_tris_occluded): one thread per ray, 128
// rays per block, no shared memory and no block-wide barrier. Each thread
// walks a binary bounding volume hierarchy that the host builds once per
// render (kernels/tri_intersect.py tri_bvh: binned SAH, at most kLeaf
// triangles a leaf, each triangle referenced once) with a while-while loop
// and a stack of kStack entries in local memory. A node is four float4 (the
// layout of Aila and Laine 2009: both children's boxes, then their codes); a
// leaf's triangles are three float4 each (v0 with the original index's bits,
// e1, e2), loaded with __ldg. The nearest hit visits the nearer child first
// and culls boxes against its running best t; the any hit stops at its first
// hit. The Morton lane sort of the tracer keeps a warp's rays together. The
// traversal, the box test and the tie rule are bvh.cuh's, shared with the
// flat leaf-disk kernels of leaf_intersect.cu.
//
// Instanced soups: a sweep of sphere-culled groups. Triangles come in groups
// of 64 consecutive triangles, each with a bounding sphere over its vertices
// (spheres row 1 + g; row 0 bounds the whole soup and serves as the
// per-instance sphere). A block stages a group in shared memory (9 floats per
// triangle, 2.25 KB) when __syncthreads_or says any of its rays can reach the
// group's sphere within its current cap; each thread tests only groups it
// reaches itself.
//
// The culls are conservative. A triangle the exact test accepts is met by
// the ray's line within delta, the rounding of tvec = p - v0 and of the
// barycentric products (about kLineSlack times the coordinates' magnitude),
// at a t that the test computes with a relative error of up to ~1e-3 at
// grazing incidence (|det| > 1e-12 admits cosines down to ~1e-4 for
// metre-sized triangles): so a sphere's segment is lengthened by kCapSlack
// of the distance at both ends, and its radius^2 is inflated to cover R +
// delta. A sliver (a 4.5 m by 2.3 cm branch side) seen at a grazing angle
// multiplies both errors: its sharp corner where two edge tests round
// outward together, and the computed t. On rays aimed at a wood skeleton's
// edges and vertices from 50-300 m, the worst accepted (ray, triangle) pair
// needed a box grown by 5 kLineSlack times the coordinates' magnitude, and
// its hit came 9.4e-3 of the distance before the line entered the grown
// box. So a box is grown by kBoxSlack = 50 kLineSlack, and its segment is
// lengthened by kBoxCapSlack = 5e-2 of the distance. The nearest hit's cap
// is its best t so far, so a triangle has to be reached with the cap at its
// own t, not only at t_max. A box test takes the near and far planes
// by the sign of 1 / d: a direction component of +-0 gives +-inf, an origin
// on a grown face of such an axis gives 0 * inf = NaN, and fmaxf/fminf drop
// it, so the axis bounds nothing (NaN counts as reached). The box test is
// monotone under containment and a parent's box is the exact union of its
// children's, so a leaf that is reached has every ancestor reached. No cull
// drops a triangle the dense sweep would hit, and neither the grouping nor
// the visit order changes the result. The library is built with
// -fmad=false; the fused multiply-adds of the exact test are written out
// (__fmaf_rn) where the reference has them and nowhere else, and the plain
// versions round the same way, so kernels and plain versions agree bit for
// bit.
//
// What bounds it on this card: the soup and its hierarchy are a few MB and
// stay in L2, each ray moves 28 bytes in and 17 (nearest) or 1 (any hit) out,
// and each exact test is ~45 float32 operations with one division, each box
// test ~45 more: the sweep is bound by operations, and by how many exact
// tests the cull leaves (a sliver of a thin branch fills its box badly).

#include "bvh.cuh"

namespace {

constexpr int kGroup = 64;    // triangles per bounding sphere (GROUP)
constexpr float kDetMin = 1e-12f;
constexpr float kCullSlack = 1.0001f;
constexpr float kLineSlack = 2e-6f;  // ~32 float32 ulp of the coordinates
constexpr float kCapSlack = 2e-3f;   // of the distance to a sphere

// One triangle: v0, e1 (a), e2 (b).
struct Tri {
  float v0x, v0y, v0z, ax, ay, az, bx, by, bz;
};

// Moller-Trumbore distance of the ray to triangle q, or a negative number
// where it misses (t_max is the strict upper gate).
__device__ __forceinline__ float tri_hit(const Ray& r, float t_max, const Tri& q) {
  const float pvx = fma_rn(r.dy, q.bz, -(r.dz * q.by));
  const float pvy = fma_rn(r.dz, q.bx, -(r.dx * q.bz));
  const float pvz = fma_rn(r.dx, q.by, -(r.dy * q.bx));
  const float det = dot3(q.ax, q.ay, q.az, pvx, pvy, pvz);
  if (!(fabsf(det) > kDetMin)) return -1.0f;
  const float inv = 1.0f / det;
  const float tvx = r.px - q.v0x, tvy = r.py - q.v0y, tvz = r.pz - q.v0z;
  const float u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv;
  if (!(u >= 0.0f)) return -1.0f;
  const float qvx = fma_rn(tvy, q.az, -(tvz * q.ay));
  const float qvy = fma_rn(tvz, q.ax, -(tvx * q.az));
  const float qvz = fma_rn(tvx, q.ay, -(tvy * q.ax));
  const float v = dot3(r.dx, r.dy, r.dz, qvx, qvy, qvz) * inv;
  if (!(v >= 0.0f) || !(u + v <= 1.0f)) return -1.0f;
  const float t = dot3(q.bx, q.by, q.bz, qvx, qvy, qvz) * inv;
  return (t > kEpsT && t < t_max) ? t : -1.0f;
}

// Unit geometric normal of triangle q.
__device__ __forceinline__ void tri_normal(const Tri& q, float& nx, float& ny,
                                           float& nz) {
  const float cx = fma_rn(q.ay, q.bz, -(q.az * q.by));
  const float cy = fma_rn(q.az, q.bx, -(q.ax * q.bz));
  const float cz = fma_rn(q.ax, q.by, -(q.ay * q.bx));
  const float norm = fmaxf(sqrtf(dot3(cx, cy, cz, cx, cy, cz)), 1e-12f);
  nx = cx / norm;
  ny = cy / norm;
  nz = cz / norm;
}

// The flat soups' hierarchy: a leaf's triangles are three float4 rows each.
__device__ __forceinline__ Tri load_tri(const float4* __restrict__ tris, int k,
                                        int& index) {
  const float4 a = __ldg(tris + 3 * k);
  const float4 e = __ldg(tris + 3 * k + 1);
  const float4 f = __ldg(tris + 3 * k + 2);
  index = __float_as_int(a.w);
  return Tri{a.x, a.y, a.z, e.x, e.y, e.z, f.x, f.y, f.z};
}

__global__ void __launch_bounds__(kThreads)
bvh_nearest_kernel(const float* __restrict__ p, const float* __restrict__ d,
                   const float* __restrict__ t_max, const float4* __restrict__ nodes,
                   const float4* __restrict__ tris, float* __restrict__ t_hit,
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
        const Tri q = load_tri(tris, k, index);
        best.take(tri_hit(r, tm, q), index / kChunk,
                  [&](float& nx, float& ny, float& nz) { tri_normal(q, nx, ny, nz); });
      }
      return false;
    });
  }
  store_nearest(best, tm, b, t_hit, normal, hit);
}

__global__ void __launch_bounds__(kThreads)
bvh_occluded_kernel(const float* __restrict__ p, const float* __restrict__ d,
                    const float* __restrict__ t_max, const float4* __restrict__ nodes,
                    const float4* __restrict__ tris, bool* __restrict__ occ, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Ray r = load_ray(p, d, b);
  const float tm = t_max[b];
  bool occluded = false;
  if (tm > kEpsT) {
    traverse(r, tm, nodes, [&](int first, int end) {
      for (int k = first; k < end && !occluded; ++k) {
        int index;
        occluded = tri_hit(r, tm, load_tri(tris, k, index)) >= 0.0f;
      }
      return occluded;
    });
  }
  occ[b] = occluded;
}

// ---------------------------------------------------------------------------
// Instanced soups: the sphere-culled staged sweep.

// One staged group: SoA rows v0x v0y v0z e1x e1y e1z e2x e2y e2z.
struct Group {
  float v[9][kGroup];
};

__device__ __forceinline__ Tri staged(const Group& g, int k) {
  return Tri{g.v[0][k], g.v[1][k], g.v[2][k], g.v[3][k], g.v[4][k],
             g.v[5][k], g.v[6][k], g.v[7][k], g.v[8][k]};
}

// Can the segment p + t d, t in [0, cap], reach the sphere (conservative)?
// See the header; since 2 R delta <= 0.5e-4 R^2 + 2e4 delta^2, half of the
// relative slack on R^2 plus 2e4 delta^2 covers a radius of R + delta, and
// the other half the float32 rounding of the sphere itself. Directions are
// unit vectors.
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

// Sweep one instance frame of the soup for the nearest hit. Every thread of
// the block calls this together; `active` threads take part in the tests.
__device__ __forceinline__ void sweep_nearest(const Ray& r, float tm, bool active,
                                              Best& best, Group& g,
                                              const float* __restrict__ v0,
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
        const Tri q = staged(g, k);
        best.take(tri_hit(r, tm, q), chunk,
                  [&](float& nx, float& ny, float& nz) { tri_normal(q, nx, ny, nz); });
      }
    }
    __syncthreads();
  }
}

// Sweep one instance frame for any hit; returns with `occluded` set where
// found.
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
        if (tri_hit(r, t_max, staged(g, k)) >= 0.0f) {
          occluded = true;
          break;
        }
      }
    }
    __syncthreads();
  }
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
  Best best{tm, 0.0, 0.0, 1.0, 0, kNoChunk};
  const int chunks = (N + kChunk - 1) / kChunk;
  for (int i = 0; i < I; ++i) {
    const Ray r = make_ray(r0.px - offsets[3 * i], r0.py - offsets[3 * i + 1],
                           r0.pz - offsets[3 * i + 2], r0.dx, r0.dy, r0.dz);
    const bool reach = active && sphere_cull(r, best.t, spheres);
    if (!__syncthreads_or(reach)) continue;
    sweep_nearest(r, tm, reach, best, g, v0, e1, e2, spheres, N, i * chunks);
  }
  if (in_range) store_nearest(best, tm, b, t_hit, normal, hit);
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
  for (int i = 0; i < I; ++i) {
    const Ray r = make_ray(r0.px - offsets[3 * i], r0.py - offsets[3 * i + 1],
                           r0.pz - offsets[3 * i + 2], r0.dx, r0.dy, r0.dz);
    const bool reach = active && !occluded && sphere_cull(r, tm, spheres);
    if (!__syncthreads_or(reach)) continue;
    sweep_occluded(r, tm, reach, occluded, g, v0, e1, e2, spheres, N);
  }
  if (in_range) occ[b] = occluded;
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 = launched). `nodes` and
// `tris` are tri_bvh's arrays (16-byte aligned).
extern "C" int ray_tris_nearest_launch(const float* p, const float* d,
                                       const float* t_max, const float* nodes,
                                       const float* tris, float* t_hit, float* normal,
                                       bool* hit, int B, void* stream) {
  bvh_nearest_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), t_hit, normal, hit, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_tris_occluded_launch(const float* p, const float* d,
                                        const float* t_max, const float* nodes,
                                        const float* tris, bool* occ, int B,
                                        void* stream) {
  bvh_occluded_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), occ, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_tris_nearest_instanced_launch(
    const float* p, const float* d, const float* t_max, const float* v0,
    const float* e1, const float* e2, const float* spheres, const float* offsets,
    float* t_hit, float* normal, bool* hit, int B, int N, int I, void* stream) {
  tri_nearest_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, v0, e1, e2, spheres, offsets, t_hit, normal, hit, B, N, I);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_tris_occluded_instanced_launch(
    const float* p, const float* d, const float* t_max, const float* v0,
    const float* e1, const float* e2, const float* spheres, const float* offsets,
    bool* occ, int B, int N, int I, void* stream) {
  tri_occluded_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, v0, e1, e2, spheres, offsets, occ, B, N, I);
  return static_cast<int>(cudaGetLastError());
}
