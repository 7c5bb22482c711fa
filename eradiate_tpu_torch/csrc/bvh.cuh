// Device code shared by the triangle kernels of tri_intersect.cu and the
// leaf kernels of leaf_intersect.cu: the ray, the order-free nearest-hit
// record, and the traversal of the bounding volume hierarchy that the host
// builds once per render (eradiate_tpu_torch/kernels/bvh.py), in one level
// or in two.
//
// The hierarchy: a binary tree, each inner node four float4 in the layout of
// Aila and Laine (2009): both children's boxes, then their codes. A code >= 0
// is an inner node; a code < 0 is the leaf ~(first << kLeafBits | count),
// count (at most kLeaf) item rows from first. Row 0 is the root.
//
// Two levels (instanced tables): a top hierarchy whose items are instances,
// float4 (offset, original row's bits), each instance's box the canonical
// root box moved by its offset and grown by kBoxSlack |offset|_1 (bvh.py
// instance_level), above the canonical hierarchy in its own frame. The
// world ray walks the top; at a top leaf, each instance translates the ray,
// p - offset (one float32 subtraction per component, as the reference), and
// the translated ray walks the canonical hierarchy. Both walks read the same
// cap. The growth makes the world test's margin at least the translated
// one's (|p - offset|_1 <= |p|_1 + |offset|_1), so an instance whose
// canonical items the translated walk would reach is reached.
//
// The cull is conservative. A box is grown by delta = kBoxSlack times the
// coordinates' magnitude (the L1 distance to the box's far corner plus |p|),
// and the segment is lengthened by kBoxCapSlack of that distance at both
// ends (tri_intersect.cu's header says how the triangle slivers set them).
// The near and far planes follow the sign of 1 / d: a direction component of
// +-0 gives +-inf, an origin on a grown face of such an axis gives 0 * inf =
// NaN, and fmaxf/fminf drop it, so the axis bounds nothing (NaN counts as
// reached). The box test is monotone under containment and a parent's box is
// the exact union of its children's, so a leaf that is reached has every
// ancestor reached.
//
// The float64 builds (the double modes) keep the float32 hierarchy: their
// items and exact tests are float64, and the box tests read the float64 ray
// rounded to the nearest float32 (box_ray) and the running cap rounded up
// (cull_cap). The rounding moves the ray by 6e-8 of its coordinates and of
// the distance it travels, far inside the margins above.
//
// Every file that includes this header is built with -fmad=false; the fused
// multiply-adds of the exact tests are written out (__fmaf_rn, __fma_rn).

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 512;   // items per tie-averaging chunk (CHUNK)
constexpr int kLeaf = 4;      // most items per leaf (LEAF)
constexpr int kLeafBits = 3;  // leaf code ~(first << 3 | count)
constexpr int kStack = 64;    // traversal stack entries (STACK)
constexpr int kTopStack = 16; // the two-level walk's outer stack (TOP_STACK)
constexpr int kDone = INT_MIN;      // no node left; no leaf has this code
constexpr int kNoChunk = INT_MAX;   // no hit yet
constexpr float kEpsT = 1e-7f;
constexpr float kBoxSlack = 1e-4f;     // a box's growth, of the coordinates (BOX_SLACK)
constexpr float kBoxCapSlack = 5e-2f;  // of the distance to a box (CAP_SLACK)
static_assert(kLeaf < (1 << kLeafBits), "a leaf's count must fit its code");

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

__device__ __forceinline__ Ray load_ray(const float* __restrict__ p,
                                        const float* __restrict__ d, int b) {
  return make_ray(p[3 * b], p[3 * b + 1], p[3 * b + 2], d[3 * b], d[3 * b + 1],
                  d[3 * b + 2]);
}

// A float64 ray (the float64 builds' exact tests).
struct Ray64 {
  double px, py, pz, dx, dy, dz;
  double l1;  // |px| + |py| + |pz|
};

__device__ __forceinline__ Ray64 make_ray64(double px, double py, double pz, double dx,
                                            double dy, double dz) {
  return Ray64{px, py, pz, dx, dy, dz, fabs(px) + fabs(py) + fabs(pz)};
}

__device__ __forceinline__ Ray64 load_ray64(const double* __restrict__ p,
                                            const double* __restrict__ d, int b) {
  return make_ray64(p[3 * b], p[3 * b + 1], p[3 * b + 2], d[3 * b], d[3 * b + 1],
                    d[3 * b + 2]);
}

// The ray the box tests read: a float64 ray rounded to the nearest float32.
__device__ __forceinline__ Ray box_ray(const Ray64& r) {
  return make_ray(__double2float_rn(r.px), __double2float_rn(r.py), __double2float_rn(r.pz),
                  __double2float_rn(r.dx), __double2float_rn(r.dy), __double2float_rn(r.dz));
}

// The cap the box tests read: a float32 cap as it is, a float64 one rounded
// up, so that the cull never cuts a segment short.
__device__ __forceinline__ float cull_cap(float cap) { return cap; }
__device__ __forceinline__ float cull_cap(double cap) { return __double2float_ru(cap); }

// Running nearest hit with the reference's tie rule, in a form that does not
// depend on the order of the visits: a hit replaces the best when its t is
// smaller, or equal with a lower chunk; it adds its normal when t and chunk
// are equal. The tied normals are summed in float64 from zero, as the
// reference's masked sum: -0.0 becomes +0.0, and the order of the sum does
// not matter.
struct Best {
  float t;            // running cap: t_max until a hit is found
  double sx, sy, sz;  // sum of the tied items' normals
  int count;          // tied items summed (0: no hit)
  int chunk;          // (instance, 512-item chunk) id of the winner

  // Take the result th of an exact test (negative: no hit) of an item of
  // chunk ch; normal(nx, ny, nz) gives the item's normal, and is called only
  // where it is needed.
  template <class Normal>
  __device__ __forceinline__ void take(float th, int ch, Normal normal) {
    if (th < 0.0f) return;
    const bool tie = th == t;
    if (th < t || (tie && ch < chunk)) {
      float nx, ny, nz;
      normal(nx, ny, nz);
      t = th;
      sx = 0.0 + nx; sy = 0.0 + ny; sz = 0.0 + nz;
      count = 1;
      chunk = ch;
    } else if (tie && ch == chunk) {
      float nx, ny, nz;
      normal(nx, ny, nz);
      sx += nx; sy += ny; sz += nz;
      count += 1;
    }
  }
};

// The float64 builds' record: Best with float64 distances and normals. Two
// tied normals sum alike in either order; three or more are summed again in
// index order after the walk (leaf_intersect.cu, tri_intersect.cu), as the
// reference sums them, so the running sum here is used only where
// count <= 2.
struct Best64 {
  double t;
  double sx, sy, sz;
  int count;
  int chunk;

  template <class Normal>
  __device__ __forceinline__ void take(double th, int ch, Normal normal) {
    if (th < 0.0) return;
    const bool tie = th == t;
    if (th < t || (tie && ch < chunk)) {
      double nx, ny, nz;
      normal(nx, ny, nz);
      t = th;
      sx = 0.0 + nx; sy = 0.0 + ny; sz = 0.0 + nz;
      count = 1;
      chunk = ch;
    } else if (tie && ch == chunk) {
      double nx, ny, nz;
      normal(nx, ny, nz);
      sx += nx; sy += ny; sz += nz;
      count += 1;
    }
  }
};

__device__ __forceinline__ void store_nearest64(const Best64& best, double tm, int b,
                                                double* __restrict__ t_hit,
                                                double* __restrict__ normal,
                                                bool* __restrict__ hit) {
  const bool found = best.count > 0;
  const double cnt = static_cast<double>(max(best.count, 1));
  t_hit[b] = found ? best.t : tm;
  normal[3 * b] = found ? best.sx / cnt : 0.0;
  normal[3 * b + 1] = found ? best.sy / cnt : 0.0;
  normal[3 * b + 2] = found ? best.sz / cnt : 1.0;
  hit[b] = found;
}

__device__ __forceinline__ void store_nearest(const Best& best, float tm, int b,
                                              float* __restrict__ t_hit,
                                              float* __restrict__ normal,
                                              bool* __restrict__ hit) {
  const bool found = best.count > 0;
  const float cnt = static_cast<float>(max(best.count, 1));
  t_hit[b] = found ? best.t : tm;
  normal[3 * b] = found ? static_cast<float>(best.sx) / cnt : 0.0f;
  normal[3 * b + 1] = found ? static_cast<float>(best.sy) / cnt : 0.0f;
  normal[3 * b + 2] = found ? static_cast<float>(best.sz) / cnt : 1.0f;
  hit[b] = found;
}

// Per-ray constants of the box test.
struct Slab {
  float ix, iy, iz;  // 1 / d: +-inf where a component is +-0
  bool nx, ny, nz;   // 1 / d < 0: the near plane is the box's upper face
};

__device__ __forceinline__ Slab make_slab(const Ray& r) {
  Slab s;
  s.ix = 1.0f / r.dx;
  s.iy = 1.0f / r.dy;
  s.iz = 1.0f / r.dz;
  s.nx = s.ix < 0.0f;
  s.ny = s.iy < 0.0f;
  s.nz = s.iz < 0.0f;
  return s;
}

// Can the segment p + t d, t in [-slack, cap + slack], reach the box grown by
// delta (see the header)? dist bounds the L1 distance from p to any point of
// the box. Sets t_near, the entry distance, for the visit order.
__device__ __forceinline__ bool box_reach(const Ray& r, const Slab& s, float cap,
                                          float lox, float hix, float loy, float hiy,
                                          float loz, float hiz, float& t_near) {
  const float ax = lox - r.px, bx = hix - r.px;
  const float ay = loy - r.py, by = hiy - r.py;
  const float az = loz - r.pz, bz = hiz - r.pz;
  const float dist = (fmaxf(-ax, bx) + fmaxf(-ay, by)) + fmaxf(-az, bz);
  const float delta = kBoxSlack * (dist + r.l1);
  const float slack = kBoxCapSlack * dist + 1e-6f;
  const float gax = ax - delta, gbx = bx + delta;
  const float gay = ay - delta, gby = by + delta;
  const float gaz = az - delta, gbz = bz + delta;
  const float nx = (s.nx ? gbx : gax) * s.ix, fx = (s.nx ? gax : gbx) * s.ix;
  const float ny = (s.ny ? gby : gay) * s.iy, fy = (s.ny ? gay : gby) * s.iy;
  const float nz = (s.nz ? gbz : gaz) * s.iz, fz = (s.nz ? gaz : gbz) * s.iz;
  t_near = fmaxf(fmaxf(fmaxf(nx, ny), nz), -slack);
  const float t_far = fminf(fminf(fminf(fx, fy), fz), cap + slack);
  return t_near <= t_far;
}

// One step at inner node `node`: the next node to visit (a reached child,
// the nearer first with the other pushed, or the top of the stack), or kDone.
__device__ __forceinline__ int descend(const Ray& r, const Slab& s, float cap,
                                       const float4* __restrict__ nodes, int node,
                                       int* stack, int& sp) {
  const float4 n0 = __ldg(nodes + 4 * node);
  const float4 n1 = __ldg(nodes + 4 * node + 1);
  const float4 n2 = __ldg(nodes + 4 * node + 2);
  const float4 n3 = __ldg(nodes + 4 * node + 3);
  float t0, t1;
  const bool r0 = box_reach(r, s, cap, n0.x, n0.y, n0.z, n0.w, n2.x, n2.y, t0);
  const bool r1 = box_reach(r, s, cap, n1.x, n1.y, n1.z, n1.w, n2.z, n2.w, t1);
  const int c0 = __float_as_int(n3.x), c1 = __float_as_int(n3.y);
  if (r0 && r1) {
    const bool swap = t1 < t0;
    stack[sp++] = swap ? c0 : c1;
    return swap ? c1 : c0;
  }
  if (r0) return c0;
  if (r1) return c1;
  return sp > 0 ? stack[--sp] : kDone;
}

// Walk the hierarchy with a while-while loop and a stack of Stack entries in
// local memory: visit(first, end) for the item rows of each leaf that the
// segment reaches with the cap `cap` (float, or a float64 one read through
// cull_cap), which is read at every step (the nearest hit passes its
// running best t, so later boxes cull against it). Stops early where visit
// returns true.
template <int Stack = kStack, class Cap, class Visit>
__device__ __forceinline__ void traverse(const Ray& r, const Cap& cap,
                                         const float4* __restrict__ nodes, Visit visit) {
  const Slab s = make_slab(r);
  int stack[Stack];
  int sp = 0;
  int node = 0;  // the root is an inner node
  for (;;) {
    while (node >= 0) node = descend(r, s, cull_cap(cap), nodes, node, stack, sp);
    if (node == kDone) return;
    const int leaf = ~node;
    const int first = leaf >> kLeafBits;
    if (visit(first, first + (leaf & ((1 << kLeafBits) - 1)))) return;
    node = sp > 0 ? stack[--sp] : kDone;
  }
}

// The two-level walk: the world ray r over the top hierarchy `top`, and at
// each instance row j of a top leaf that it reaches (instances[j] = (offset,
// original row's bits)) the translated ray over the canonical hierarchy
// `nodes`, both with the cap `cap`: visit(ri, row, first, end) for the item
// rows of each canonical leaf reached, with the translated ray ri and the
// instance's original row. Stops early where visit returns true.
template <class Visit>
__device__ __forceinline__ void traverse_instances(const Ray& r, const float& cap,
                                                   const float4* __restrict__ top,
                                                   const float4* __restrict__ instances,
                                                   const float4* __restrict__ nodes,
                                                   Visit visit) {
  traverse<kTopStack>(r, cap, top, [&](int first, int end) {
    for (int j = first; j < end; ++j) {
      const float4 o = __ldg(instances + j);
      const Ray ri = make_ray(r.px - o.x, r.py - o.y, r.pz - o.z, r.dx, r.dy, r.dz);
      const int row = __float_as_int(o.w);
      bool stop = false;
      traverse(ri, cap, nodes, [&](int a, int b) {
        stop = visit(ri, row, a, b);
        return stop;
      });
      if (stop) return true;
    }
    return false;
  });
}

// The two-level walk of the float64 builds: as traverse_instances, with the
// float64 world ray r (its box tests on box_ray(r)), float64 instance rows
// (instances: two double2 each, (ox, oy), (oz, original row's int64 bits)),
// the translated ray p - offset in float64 and a float64 cap:
// visit(ri, row, first, end) with the float64 translated ray ri.
template <class Visit>
__device__ __forceinline__ void traverse_instances64(const Ray64& r, const double& cap,
                                                     const float4* __restrict__ top,
                                                     const double2* __restrict__ instances,
                                                     const float4* __restrict__ nodes,
                                                     Visit visit) {
  traverse<kTopStack>(box_ray(r), cap, top, [&](int first, int end) {
    for (int j = first; j < end; ++j) {
      const double2 o0 = __ldg(instances + 2 * j);
      const double2 o1 = __ldg(instances + 2 * j + 1);
      const Ray64 ri = make_ray64(r.px - o0.x, r.py - o0.y, r.pz - o1.x, r.dx, r.dy, r.dz);
      const int row = static_cast<int>(__double_as_longlong(o1.y));
      bool stop = false;
      traverse(box_ray(ri), cap, nodes, [&](int a, int b) {
        stop = visit(ri, row, a, b);
        return stop;
      });
      if (stop) return true;
    }
    return false;
  });
}

int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace
