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
// equal with a lower key; it adds its normal when t and key are equal. The
// key is the chunk, or for instanced soups (instance, chunk) (below).
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
// Instanced soups (ray_tris_{nearest,occluded}_instanced): two levels
// (kernels/tri_intersect.py tri_instanced_bvh, bvh.cuh traverse_instances),
// as the instanced leaf kernels of leaf_intersect.cu. The world ray walks a
// small hierarchy of the instances' boxes (each the canonical root box moved
// by its offset and grown by kBoxSlack |offset|_1); at each instance it
// reaches, the ray translated into the instance's frame, fl(p - offset) in
// float32 as the plain version computes it, walks the canonical soup's
// tri_bvh, stored once, with the same running cap, so a hit in a near
// instance culls the boxes of the far ones. The tie key is instance *
// ceil(N / 512) + index / 512, the instance being the offset's original
// row, so that the lower (instance, chunk) wins a tie whatever the order in
// which the walk meets them. One thread per ray, no shared memory, no
// block-wide barrier: a ray pays for the instances its segment reaches, not
// for all of them.
//
// The culls are conservative. A triangle the exact test accepts is met by
// the ray's line within the rounding of tvec = p - v0 and of the
// barycentric products (a few ulp of the coordinates' magnitude), at a t
// that the test computes with a relative error of up to ~1e-3 at grazing
// incidence (|det| > 1e-12 admits cosines down to ~1e-4 for metre-sized
// triangles). A sliver (a 4.5 m by 2.3 cm branch side) seen at a grazing
// angle multiplies both errors: its sharp corner where two edge tests round
// outward together, and the computed t. On rays aimed at a wood skeleton's
// edges and vertices from 50-300 m, the worst accepted (ray, triangle) pair
// needed a box grown by 1e-5 of the coordinates' magnitude, and its hit
// came 9.4e-3 of the distance before the line entered the grown box. So a
// box is grown by kBoxSlack = 1e-4 of the coordinates' magnitude, and its
// segment is lengthened by kBoxCapSlack = 5e-2 of the distance (bvh.cuh).
// The nearest hit's cap is its best t so far, so a triangle has to be
// reached with the cap at its own t, not only at t_max. A box test takes
// the near and far planes by the sign of 1 / d: a direction component of
// +-0 gives +-inf, an origin on a grown face of such an axis gives 0 * inf
// = NaN, and fmaxf/fminf drop it, so the axis bounds nothing (NaN counts as
// reached). The box test is monotone under containment and a parent's box
// is the exact union of its children's, so a leaf that is reached has every
// ancestor reached. No cull drops a triangle the dense sweep would hit, and
// the visit order does not change the result. The library is built with
// -fmad=false; the fused multiply-adds of the exact test are written out
// (__fmaf_rn) where the reference has them and nowhere else, and the plain
// versions round the same way, so kernels and plain versions agree bit for
// bit.
//
// The float64 builds (the double modes: *_f64 below) run the same walks
// over the same float32 hierarchies, one thread per ray, with float64 rays,
// triangles (three double4 a triangle, (v0, original index's int64 bits),
// (e1, 0), (e2, 0)) and exact tests (__fma_rn where the float32 test has
// fma_rn and nowhere else, 1.0 / det as the IEEE float64 division, the same
// 1e-12 and 1e-7 gates; the normal's norm __dsqrt_rn, clamped with fmax), the
// box tests on the ray rounded to float32 and the cap rounded up (bvh.cuh
// box_ray, cull_cap). They replace the same TPU kernels, which take float32
// only; the reference renders its double modes through its XLA sweeps,
// whose float64 arithmetic they reproduce. The float64 exact test errs far
// less than the float32 one the margins were set for, and the rounding of
// the ray moves it by 6e-8 of its coordinates. Tied float64 normals do not
// sum exactly: two sum alike in either order, and where three or more tie
// (a ray through a cap's apex meets twelve triangles at one t), the
// nearest-hit kernels sum them again after the walk in index order from
// zero (the reference's masked sum), testing the winning 512-triangle
// chunk's triangles (and, instanced, in the winning instance's frame) in
// the soup's original order.
//
// What bounds it on this card: the soup and its hierarchy are a few MB (a
// flat soup) or a few KB (a canonical soup and its instances) and stay in
// L2, each ray moves 28 bytes in and 17 (nearest) or 1 (any hit) out, and
// each exact test is ~45 float32 operations with one division, each box test
// ~45 more: the sweep is bound by operations, and by how many exact and box
// tests the cull leaves (a sliver of a thin branch fills its box badly; an
// instanced ray also tests the instance boxes and the canonical root of
// every instance it reaches), and by the divergence of the walks in a warp.
// The float64 builds move 56 bytes in and 33 or 1 out a ray, and their exact
// test is ~45 float64 operations with one float64 division, at half the
// float32 rate and a software division.

#include "bvh.cuh"

namespace {

constexpr float kDetMin = 1e-12f;

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

// A hierarchy's leaf-ordered triangles: three float4 rows each (v0 with the
// original index's bits, e1, e2).
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
// Instanced soups: the two-level traversal.

__global__ void __launch_bounds__(kThreads)
tri_ibvh_nearest_kernel(const float* __restrict__ p, const float* __restrict__ d,
                        const float* __restrict__ t_max, const float4* __restrict__ top,
                        const float4* __restrict__ instances,
                        const float4* __restrict__ nodes, const float4* __restrict__ tris,
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
        const Tri q = load_tri(tris, k, index);
        best.take(tri_hit(ri, tm, q), row * chunks + index / kChunk,
                  [&](float& nx, float& ny, float& nz) { tri_normal(q, nx, ny, nz); });
      }
      return false;
    });
  }
  store_nearest(best, tm, b, t_hit, normal, hit);
}

__global__ void __launch_bounds__(kThreads)
tri_ibvh_occluded_kernel(const float* __restrict__ p, const float* __restrict__ d,
                         const float* __restrict__ t_max, const float4* __restrict__ top,
                         const float4* __restrict__ instances,
                         const float4* __restrict__ nodes, const float4* __restrict__ tris,
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
        occluded = tri_hit(ri, tm, load_tri(tris, k, index)) >= 0.0f;
      }
      return occluded;
    });
  }
  occ[b] = occluded;
}

// ---------------------------------------------------------------------------
// The float64 builds.

constexpr double kDetMin64 = 1e-12;
constexpr double kEpsT64 = 1e-7;

struct Tri64 {
  double v0x, v0y, v0z, ax, ay, az, bx, by, bz;
};

__device__ __forceinline__ double dot3_64(double ax, double ay, double az, double bx,
                                          double by, double bz) {
  return __fma_rn(az, bz, __fma_rn(ay, by, ax * bx));
}

// tri_hit in float64: the same test, rounded as the reference under x64.
__device__ __forceinline__ double tri_hit64(const Ray64& r, double t_max, const Tri64& q) {
  const double pvx = __fma_rn(r.dy, q.bz, -(r.dz * q.by));
  const double pvy = __fma_rn(r.dz, q.bx, -(r.dx * q.bz));
  const double pvz = __fma_rn(r.dx, q.by, -(r.dy * q.bx));
  const double det = dot3_64(q.ax, q.ay, q.az, pvx, pvy, pvz);
  if (!(fabs(det) > kDetMin64)) return -1.0;
  const double inv = 1.0 / det;
  const double tvx = r.px - q.v0x, tvy = r.py - q.v0y, tvz = r.pz - q.v0z;
  const double u = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv;
  if (!(u >= 0.0)) return -1.0;
  const double qvx = __fma_rn(tvy, q.az, -(tvz * q.ay));
  const double qvy = __fma_rn(tvz, q.ax, -(tvx * q.az));
  const double qvz = __fma_rn(tvx, q.ay, -(tvy * q.ax));
  const double v = dot3_64(r.dx, r.dy, r.dz, qvx, qvy, qvz) * inv;
  if (!(v >= 0.0) || !(u + v <= 1.0)) return -1.0;
  const double t = dot3_64(q.bx, q.by, q.bz, qvx, qvy, qvz) * inv;
  return (t > kEpsT64 && t < t_max) ? t : -1.0;
}

// tri_normal in float64.
__device__ __forceinline__ void tri_normal64(const Tri64& q, double& nx, double& ny,
                                             double& nz) {
  const double cx = __fma_rn(q.ay, q.bz, -(q.az * q.by));
  const double cy = __fma_rn(q.az, q.bx, -(q.ax * q.bz));
  const double cz = __fma_rn(q.ax, q.by, -(q.ay * q.bx));
  const double norm = fmax(__dsqrt_rn(dot3_64(cx, cy, cz, cx, cy, cz)), 1e-12);
  nx = cx / norm;
  ny = cy / norm;
  nz = cz / norm;
}

// Triangle row k of a float64 hierarchy's soup (six double2), and its index.
__device__ __forceinline__ Tri64 load_tri64(const double2* __restrict__ tris, int k,
                                            int& index) {
  const double2 a = __ldg(tris + 6 * k);
  const double2 b = __ldg(tris + 6 * k + 1);
  const double2 e = __ldg(tris + 6 * k + 2);
  const double2 f = __ldg(tris + 6 * k + 3);
  const double2 g = __ldg(tris + 6 * k + 4);
  const double2 h = __ldg(tris + 6 * k + 5);
  index = static_cast<int>(__double_as_longlong(b.y));
  return Tri64{a.x, a.y, b.x, e.x, e.y, f.x, g.x, g.y, h.x};
}

// Triangle `i` of the soup in its original order.
__device__ __forceinline__ Tri64 original_tri64(const double* __restrict__ v0,
                                                const double* __restrict__ e1,
                                                const double* __restrict__ e2, int i) {
  return Tri64{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2], e1[3 * i], e1[3 * i + 1],
               e1[3 * i + 2], e2[3 * i], e2[3 * i + 1], e2[3 * i + 2]};
}

// Three or more tied normals: sum them again from zero in index order over
// 512-triangle chunk `chunk` of the soup (the reference's masked sum).
__device__ __forceinline__ void resum_ties(Best64& best, const Ray64& r, double tm, int chunk,
                                           const double* __restrict__ v0,
                                           const double* __restrict__ e1,
                                           const double* __restrict__ e2, int N) {
  if (best.count < 3) return;
  double sx = 0.0, sy = 0.0, sz = 0.0;
  int count = 0;
  const int end = min(N, (chunk + 1) * kChunk);
  for (int i = chunk * kChunk; i < end; ++i) {
    const Tri64 q = original_tri64(v0, e1, e2, i);
    if (tri_hit64(r, tm, q) == best.t) {
      double nx, ny, nz;
      tri_normal64(q, nx, ny, nz);
      sx += nx; sy += ny; sz += nz;
      ++count;
    }
  }
  best.sx = sx; best.sy = sy; best.sz = sz;
  best.count = count;
}

__global__ void __launch_bounds__(kThreads)
bvh_nearest_f64_kernel(const double* __restrict__ p, const double* __restrict__ d,
                       const double* __restrict__ t_max, const float4* __restrict__ nodes,
                       const double2* __restrict__ tris, const double* __restrict__ v0,
                       const double* __restrict__ e1, const double* __restrict__ e2,
                       double* __restrict__ t_hit, double* __restrict__ normal,
                       bool* __restrict__ hit, int B, int N) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Ray64 r = load_ray64(p, d, b);
  const double tm = t_max[b];
  Best64 best{tm, 0.0, 0.0, 1.0, 0, kNoChunk};
  // no t satisfies 1e-7 < t < t_max below this: the lane visits nothing
  if (tm > kEpsT64) {
    traverse(box_ray(r), best.t, nodes, [&](int first, int end) {
      for (int k = first; k < end; ++k) {
        int index;
        const Tri64 q = load_tri64(tris, k, index);
        best.take(tri_hit64(r, tm, q), index / kChunk,
                  [&](double& nx, double& ny, double& nz) { tri_normal64(q, nx, ny, nz); });
      }
      return false;
    });
    resum_ties(best, r, tm, best.chunk, v0, e1, e2, N);
  }
  store_nearest64(best, tm, b, t_hit, normal, hit);
}

__global__ void __launch_bounds__(kThreads)
bvh_occluded_f64_kernel(const double* __restrict__ p, const double* __restrict__ d,
                        const double* __restrict__ t_max, const float4* __restrict__ nodes,
                        const double2* __restrict__ tris, bool* __restrict__ occ, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Ray64 r = load_ray64(p, d, b);
  const double tm = t_max[b];
  bool occluded = false;
  if (tm > kEpsT64) {
    traverse(box_ray(r), tm, nodes, [&](int first, int end) {
      for (int k = first; k < end && !occluded; ++k) {
        int index;
        occluded = tri_hit64(r, tm, load_tri64(tris, k, index)) >= 0.0;
      }
      return occluded;
    });
  }
  occ[b] = occluded;
}

__global__ void __launch_bounds__(kThreads)
tri_ibvh_nearest_f64_kernel(const double* __restrict__ p, const double* __restrict__ d,
                            const double* __restrict__ t_max, const float4* __restrict__ top,
                            const double2* __restrict__ instances,
                            const float4* __restrict__ nodes,
                            const double2* __restrict__ tris, const double* __restrict__ v0,
                            const double* __restrict__ e1, const double* __restrict__ e2,
                            const double* __restrict__ offsets, double* __restrict__ t_hit,
                            double* __restrict__ normal, bool* __restrict__ hit, int B, int N) {
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
        const Tri64 q = load_tri64(tris, k, index);
        best.take(tri_hit64(ri, tm, q), row * chunks + index / kChunk,
                  [&](double& nx, double& ny, double& nz) { tri_normal64(q, nx, ny, nz); });
      }
      return false;
    });
    if (best.count >= 3) {
      // the winner's instance frame, the ray translated as the walk did
      const int row = best.chunk / chunks;
      const Ray64 ri = make_ray64(r.px - offsets[3 * row], r.py - offsets[3 * row + 1],
                                  r.pz - offsets[3 * row + 2], r.dx, r.dy, r.dz);
      resum_ties(best, ri, tm, best.chunk % chunks, v0, e1, e2, N);
    }
  }
  store_nearest64(best, tm, b, t_hit, normal, hit);
}

__global__ void __launch_bounds__(kThreads)
tri_ibvh_occluded_f64_kernel(const double* __restrict__ p, const double* __restrict__ d,
                             const double* __restrict__ t_max, const float4* __restrict__ top,
                             const double2* __restrict__ instances,
                             const float4* __restrict__ nodes,
                             const double2* __restrict__ tris, bool* __restrict__ occ, int B) {
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
        occluded = tri_hit64(ri, tm, load_tri64(tris, k, index)) >= 0.0;
      }
      return occluded;
    });
  }
  occ[b] = occluded;
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

// `top`, `instances`, `nodes` and `tris` are tri_instanced_bvh's arrays
// (16-byte aligned); N is the canonical soup's triangle count (the tie key's
// chunks).
extern "C" int ray_tris_nearest_instanced_launch(
    const float* p, const float* d, const float* t_max, const float* top,
    const float* instances, const float* nodes, const float* tris, float* t_hit,
    float* normal, bool* hit, int B, int N, void* stream) {
  tri_ibvh_nearest_kernel<<<blocks_for(B), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(top),
      reinterpret_cast<const float4*>(instances), reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), t_hit, normal, hit, B, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_tris_occluded_instanced_launch(
    const float* p, const float* d, const float* t_max, const float* top,
    const float* instances, const float* nodes, const float* tris, bool* occ, int B,
    void* stream) {
  tri_ibvh_occluded_kernel<<<blocks_for(B), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(top),
      reinterpret_cast<const float4*>(instances), reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), occ, B);
  return static_cast<int>(cudaGetLastError());
}

// The float64 builds: float64 rays, outputs and soups (tri_bvh and
// tri_instanced_bvh of float64 triangles; the nodes stay float32). The
// nearest hits also take the soup (and the offsets) in their original
// order, where they sum three or more tied normals; N is the triangle count.
extern "C" int ray_tris_nearest_f64_launch(
    const double* p, const double* d, const double* t_max, const float* nodes,
    const double* tris, const double* v0, const double* e1, const double* e2, double* t_hit,
    double* normal, bool* hit, int B, int N, void* stream) {
  bvh_nearest_f64_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const double2*>(tris), v0, e1, e2, t_hit, normal, hit, B, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_tris_occluded_f64_launch(const double* p, const double* d,
                                            const double* t_max, const float* nodes,
                                            const double* tris, bool* occ, int B,
                                            void* stream) {
  bvh_occluded_f64_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const double2*>(tris), occ, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_tris_nearest_instanced_f64_launch(
    const double* p, const double* d, const double* t_max, const float* top,
    const double* instances, const float* nodes, const double* tris, const double* v0,
    const double* e1, const double* e2, const double* offsets, double* t_hit, double* normal,
    bool* hit, int B, int N, void* stream) {
  tri_ibvh_nearest_f64_kernel<<<blocks_for(B), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(top),
      reinterpret_cast<const double2*>(instances), reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const double2*>(tris), v0, e1, e2, offsets, t_hit, normal, hit, B, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_tris_occluded_instanced_f64_launch(
    const double* p, const double* d, const double* t_max, const float* top,
    const double* instances, const float* nodes, const double* tris, bool* occ, int B,
    void* stream) {
  tri_ibvh_occluded_f64_kernel<<<blocks_for(B), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      p, d, t_max, reinterpret_cast<const float4*>(top),
      reinterpret_cast<const double2*>(instances), reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const double2*>(tris), occ, B);
  return static_cast<int>(cudaGetLastError());
}
