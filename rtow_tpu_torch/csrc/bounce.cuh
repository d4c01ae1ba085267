// One bounce of one lane: device code shared by the port's kernels
// (megakernel.cu = K1, flat_bounce.cu = K3, grad_fwd.cu = K4,
// grad_bwd.cu = K5).
//
// The sphere, triangle, sky and three-material subset of
// rtow_tpu/ops/pallas_megakernel.py:_bounce_core (:1329, "K2"): the counter
// RNG (_mix, _uniform :112-131), the nearest-sphere sweep and the triangle
// sweep with its per-block slab cull and hierarchy (_sweep_all :390), the
// hit record re-derived from the winner's parameters (_hit_basics :891),
// the Lambertian / metal / dielectric scatter and the sky (_shade_pure :998),
// and the scatter draws (_draw_scatter :1225).  The plain PyTorch version is
// nearest_sphere + nearest_triangle + shade in
// rtow_tpu_torch/ops/megakernel.py.  Each of K1, K3, K4 and K5 has an
// instance for spheres only (bounce_lane_t<false>) and one that sweeps
// triangles after them (bounce_lane_t<true>; K3 has this one only).
// The lit instances (bounce_lane_t<kTris, true>; K3's is
// bounce_lane_t<true, true>) add the rest of _bounce_core (:1329-1430):
// emission with its MIS weight, next-event estimation with the shadow
// sweep (_nee_contrib :1244, ops/lights.py), constant-density media
// (ops/volumes.py), checker and noise textures (models/materials.py) and
// Russian roulette; their plain version is bounce_lanes in
// ops/megakernel.py.  Triangles are one-sided unless Tris::side_mask says
// two-sided (K1 and K3 only; the lights stay one-sided either way, as in
// JAX).
//
// Numbers: float32 throughout; the kernels are built with -fmad=false and
// IEEE division and square root, so every operation here rounds as in the
// plain version and both take the same discrete decisions.
//
// The sphere table is (npad, 16) float32 rows read as 4 float4:
//   c0x c0y c0z dcx | dcy dcz r alr | alg alb fuzz ir | kind al2r al2g al2b
// Padding rows have r = 0 and a far-away center, so they are never hit.
// The triangle table (struct Tris) is (n_blocks * block, 16) float32 rows:
//   v0x v0y v0z e1x | e1y e1z e2x e2y | e2z alr alg alb | fuzz ir kind 0
// Winner ids: spheres 0 .. npad - 1, triangles npad + row.
//
// Every function is inline host-and-device code: the kernels run it, the
// launchers call salt_of on the host, and a host build that defines RTOW_HD
// (as `inline`) and float4 before including this header runs the same
// per-lane arithmetic on the CPU.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifndef RTOW_HD
#define RTOW_HD __host__ __device__ __forceinline__
#endif

namespace rtow {

constexpr int kCols = 16;  // floats per table row = 4 float4
constexpr int kCont = 13;  // ox oy oz dx dy dz tm tpr tpg tpb rr rg rb

constexpr float kTMin = 1e-3f;
constexpr float kBig = 3.0e38f;
constexpr float kInv24 = 1.0f / 16777216.0f;
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kEps12 = 1e-12f;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kSaltStride = 40503u;

constexpr float kMetal = 1.0f;
constexpr float kDielectric = 2.0f;
constexpr float kDetMin = 1e-6f;  // the backface cull's determinant floor
constexpr int kSuper = 16;        // children per hierarchy level

RTOW_HD uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

RTOW_HD float uniform(uint32_t lane, uint32_t salt, uint32_t draw) {
  const uint32_t h = mix(lane ^ (salt + draw * kGolden));
  return static_cast<float>(static_cast<int>(h >> 8)) * kInv24;
}

// The per-step salt mix(seed + it * 40503), `it` taken mod 2**32.
RTOW_HD uint32_t salt_of(int seed, uint32_t it) {
  return mix(static_cast<uint32_t>(seed) + it * kSaltStride);
}

// A lane's hash from its id (pallas_grad.py:_lane_u32, :93).
RTOW_HD uint32_t lane_hash(uint32_t id) { return mix(id * kGolden); }

struct Ray {
  float ox, oy, oz, dx, dy, dz, tm;
};

// Nearest hit over every table row, at a t below t_init (kBig, or the
// shadow sweep's threshold).  Rows are tested in table order with a strict
// `<`, so the first minimal t wins: the JAX sweep's tie rule (first minimum
// inside a 128-row block, strictly smaller across blocks).
RTOW_HD void nearest_sphere(const float4* tbl, int npad, const Ray& r,
                            float a, float inv_a, float t_init, float* best_t,
                            int* best_k) {
  float bt = t_init;
  int bk = 0;
  for (int k = 0; k < npad; ++k) {
    const float4 p0 = tbl[4 * k];
    const float4 p1 = tbl[4 * k + 1];
    const float ocx = r.ox - (p0.x + r.tm * p0.w);
    const float ocy = r.oy - (p0.y + r.tm * p1.x);
    const float ocz = r.oz - (p0.z + r.tm * p1.y);
    const float h = ocx * r.dx + ocy * r.dy + ocz * r.dz;
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - p1.z * p1.z;
    const float disc = h * h - a * cc;
    if (disc > 0.0f) {
      const float sq = sqrtf(disc);
      const float near = (-h - sq) * inv_a;
      const float v = near >= kTMin ? near : (-h + sq) * inv_a;
      if (v >= kTMin && v < bt) {
        bt = v;
        bk = k;
      }
    }
  }
  *best_t = bt;
  *best_k = bk;
}

RTOW_HD void nearest_sphere(const float4* tbl, int npad, const Ray& r,
                            float a, float inv_a, float* best_t, int* best_k) {
  nearest_sphere(tbl, npad, r, a, inv_a, kBig, best_t, best_k);
}

// The hit record, with t re-derived from the winner's parameters (the root
// nearer the sweep's best_t), and the intermediates the adjoint reuses.
struct Hit {
  float cx, cy, cz, r;    // the winner's center at time tm, and its radius
  float ocx, ocy, ocz;    // origin - center
  float h, cc, disc, sq;  // the quadratic
  bool near_root;         // t is the near root
  float t, px, py, pz;    // the hit point
  float r_abs, flip;
  float nx, ny, nz;       // unit normal, against the ray
  bool front;
};

RTOW_HD Hit hit_record(const float4* tbl, int k, float best_t, const Ray& r,
                       float a, float inv_a) {
  Hit e;
  const float4 q0 = tbl[4 * k];
  const float4 q1 = tbl[4 * k + 1];
  e.cx = q0.x + r.tm * q0.w;
  e.cy = q0.y + r.tm * q1.x;
  e.cz = q0.z + r.tm * q1.y;
  e.r = q1.z;
  e.ocx = r.ox - e.cx;
  e.ocy = r.oy - e.cy;
  e.ocz = r.oz - e.cz;
  e.h = e.ocx * r.dx + e.ocy * r.dy + e.ocz * r.dz;
  e.cc = e.ocx * e.ocx + e.ocy * e.ocy + e.ocz * e.ocz - e.r * e.r;
  e.disc = e.h * e.h - a * e.cc;
  e.sq = sqrtf(e.disc > 0.0f ? e.disc : 1.0f);
  const float near = (-e.h - e.sq) * inv_a;
  const float far = (-e.h + e.sq) * inv_a;
  e.near_root = fabsf(near - best_t) <= fabsf(far - best_t);
  e.t = e.near_root ? near : far;
  e.px = r.ox + e.t * r.dx;
  e.py = r.oy + e.t * r.dy;
  e.pz = r.oz + e.t * r.dz;
  e.r_abs = e.r == 0.0f ? 1.0f : fabsf(e.r);
  const float nx = (e.px - e.cx) / e.r_abs;
  const float ny = (e.py - e.cy) / e.r_abs;
  const float nz = (e.pz - e.cz) / e.r_abs;
  e.front = (r.dx * nx + r.dy * ny + r.dz * nz < 0.0f) != (e.r < 0.0f);
  e.flip = e.front ? 1.0f : -1.0f;
  e.nx = nx * e.flip;
  e.ny = ny * e.flip;
  e.nz = nz * e.flip;
  return e;
}

// The bounce's draws: a unit vector and the dielectric choice.
struct Draws {
  float uvx, uvy, uvz, choice;
};

RTOW_HD Draws draw_scatter(uint32_t lane, uint32_t salt) {
  Draws w;
  const float uz = 1.0f - 2.0f * uniform(lane, salt, 5);
  const float uu = uniform(lane, salt, 6);
  const float one_m = 1.0f - uz * uz;
  const float uxy = sqrtf(one_m > 0.0f ? one_m : 0.0f);
  const float uph = kTwoPi * uu;
  w.uvx = uxy * cosf(uph);
  w.uvy = uxy * sinf(uph);
  w.uvz = uz;
  w.choice = uniform(lane, salt, 7);
  return w;
}

// The scattered direction and attenuation of the winner's material, and the
// dielectric's intermediates the adjoint reuses.
struct Scatter {
  float dx, dy, dz, atr, atg, atb;
  float inv_dlen, udx, udy, udz, cos_raw, cos_t, ir_safe, ratio, sqk;
  bool must_reflect, k_ok;
};

// The winner's material: albedo, fuzz, refraction index, kind code.
struct Material {
  float alr, alg, alb, fuzz, ir, kind;
};

RTOW_HD Material sphere_material(const float4* tbl, int k) {
  const float4 q1 = tbl[4 * k + 1];
  const float4 q2 = tbl[4 * k + 2];
  return Material{q1.w, q2.x, q2.y, q2.z, q2.w, tbl[4 * k + 3].x};
}

RTOW_HD Scatter scatter(const Material& m, const Hit& e, const Ray& r,
                        float a, const Draws& w) {
  const float kind = m.kind;
  const float fuzz = m.fuzz;
  Scatter s;
  s.atr = m.alr;
  s.atg = m.alg;
  s.atb = m.alb;
  if (kind == kMetal) {  // reflect(raw d) + fuzz * unit
    const float ddn2 = 2.0f * (r.dx * e.nx + r.dy * e.ny + r.dz * e.nz);
    s.dx = r.dx - ddn2 * e.nx + fuzz * w.uvx;
    s.dy = r.dy - ddn2 * e.ny + fuzz * w.uvy;
    s.dz = r.dz - ddn2 * e.nz + fuzz * w.uvz;
  } else if (kind == kDielectric) {  // Schlick + TIR, + fuzz
    s.inv_dlen = 1.0f / sqrtf(a);
    s.udx = r.dx * s.inv_dlen;
    s.udy = r.dy * s.inv_dlen;
    s.udz = r.dz * s.inv_dlen;
    s.cos_raw = -(s.udx * e.nx + s.udy * e.ny + s.udz * e.nz);
    s.cos_t = s.cos_raw > 1.0f ? 1.0f : s.cos_raw;
    const float s2 = 1.0f - s.cos_t * s.cos_t;
    const float sin_t = sqrtf(s2 < kEps12 ? kEps12 : s2);
    const float ir = m.ir;
    s.ir_safe = ir > 0.0f ? ir : 1.0f;
    s.ratio = e.front ? 1.0f / s.ir_safe : s.ir_safe;
    const bool cannot = s.ratio * sin_t > 1.0f;
    float r0 = (1.0f - s.ratio) / (1.0f + s.ratio);
    r0 = r0 * r0;
    const float omc = 1.0f - s.cos_t;
    const float omc2 = omc * omc;
    const float refl_p = r0 + (1.0f - r0) * omc2 * omc2 * omc;
    s.must_reflect = cannot || refl_p > w.choice;
    if (s.must_reflect) {
      const float udn2 = 2.0f * (s.udx * e.nx + s.udy * e.ny + s.udz * e.nz);
      s.dx = s.udx - udn2 * e.nx;
      s.dy = s.udy - udn2 * e.ny;
      s.dz = s.udz - udn2 * e.nz;
    } else {
      const float k_raw =
          1.0f - s.ratio * s.ratio * (1.0f - s.cos_t * s.cos_t);
      s.k_ok = k_raw > 0.0f;
      s.sqk = s.k_ok ? sqrtf(k_raw) : 0.0f;
      s.dx = s.ratio * s.udx + (s.ratio * s.cos_t - s.sqk) * e.nx;
      s.dy = s.ratio * s.udy + (s.ratio * s.cos_t - s.sqk) * e.ny;
      s.dz = s.ratio * s.udz + (s.ratio * s.cos_t - s.sqk) * e.nz;
    }
    s.dx = s.dx + fuzz * w.uvx;
    s.dy = s.dy + fuzz * w.uvy;
    s.dz = s.dz + fuzz * w.uvz;
    s.atr = s.atg = s.atb = 1.0f;
  } else {  // Lambertian: n + unit (degenerate -> n)
    s.dx = e.nx + w.uvx;
    s.dy = e.ny + w.uvy;
    s.dz = e.nz + w.uvz;
    if (s.dx * s.dx + s.dy * s.dy + s.dz * s.dz < kEps12) {
      s.dx = e.nx;
      s.dy = e.ny;
      s.dz = e.nz;
    }
  }
  return s;
}

// ---- triangles -----------------------------------------------------------

// x's bits and m: with m = kKeepSign x itself, with kDropSign |x|.
constexpr uint32_t kKeepSign = 0xFFFFFFFFu;
constexpr uint32_t kDropSign = 0x7FFFFFFFu;
RTOW_HD float sign_masked(float x, uint32_t m) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(__float_as_uint(x) & m);
#else
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  u &= m;
  memcpy(&x, &u, sizeof x);
  return x;
#endif
}

// The triangle table and its cull hierarchy: per-level AABBs, 8 floats a
// box (min xyz, max xyz, 0, 0): blocks of `block` rows, supers of kSuper
// blocks, hypers of kSuper supers (n_super / n_hyper 0 where a level is
// absent).  Rows past `count` are padding: zero, never hit, not tested.
// side_mask, the cull flag: kKeepSign tests the front side only (the
// reference's backface cull), kDropSign both sides (JAX's cull=False).
struct Tris {
  const float4* tbl;
  const float4* boxes;
  const float4* supers;
  const float4* hypers;
  int n_blocks, n_super, n_hyper, block, count;
  uint32_t side_mask = kKeepSign;
};

// The sweep's work, counted per thread for the kernels' stats.
struct Tally {
  unsigned long long boxes = 0, tris = 0, shadows = 0;
  unsigned long long sph_boxes = 0, sph_rows = 0;  // K1's culled sweep
};

#ifdef __CUDACC__
// Adds n, summed over the calling warp, to *to: one atomic per warp.  Every
// thread of the warp must call it.
__device__ __forceinline__ void warp_add(unsigned long long n,
                                         unsigned long long* to) {
  for (int off = 16; off > 0; off >>= 1)
    n += __shfl_down_sync(0xFFFFFFFFu, n, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(to, n);
}

// The blocks of `kernel` (`threads` each, `smem` bytes of dynamic shared
// memory, which it is allowed) the card holds at once, into *held: the
// grid of K4's and K5's warp forms.
template <class Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int threads, int smem,
                                   int* held) {
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  *held = (per_sm > 0 ? per_sm : 1) * sms;
  return err;
}

// K4's and K5's choice of form: where `live` (a device count of the live
// lanes, or null) is at most `cut`, the warp form runs the launch and the
// thread form's blocks exit at once; a uniform branch, so the host never
// reads the count.
__device__ __forceinline__ bool warp_form_runs(const long long* live,
                                               int cut) {
  return live != nullptr && *live <= cut;
}
#endif

// Slab test of box b (two float4: min xyz + max x, max yz): whether the ray
// enters it inside [T_MIN, best_t] (pallas_megakernel.py:_box_enter_exit,
// :444).  fminf / fmaxf ignore a NaN from 0 * inf, as torch.fmin / fmax do
// in the plain version.
RTOW_HD bool box_entered(const float4* box, int b, const Ray& r, float idx,
                         float idy, float idz, float best_t) {
  const float4 lo = box[2 * b];
  const float4 hi = box[2 * b + 1];
  const float tx0 = (lo.x - r.ox) * idx;
  const float tx1 = (lo.w - r.ox) * idx;
  const float ty0 = (lo.y - r.oy) * idy;
  const float ty1 = (hi.x - r.oy) * idy;
  const float tz0 = (lo.z - r.oz) * idz;
  const float tz1 = (hi.y - r.oz) * idz;
  const float enter = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                            fmaxf(fminf(tz0, tz1), kTMin));
  const float exit = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fminf(fmaxf(tz0, tz1), best_t));
  return exit > enter;
}

// ---- K1's culled sphere sweep --------------------------------------------

// How a ray sweeps the sphere table: every row (K3, K4, K5), or only the
// row groups whose box it enters (K1).  A compile-time policy of
// bounce_lane_t and next_event, as Sweep is, so the instances that test
// every row compile as they did before the cull existed.
enum class SphereCull { kNone, kGroups };

// Rows per group of K1's sphere cull (megakernel.SPHERE_GROUP): the
// fastest of 16, 32, 64 and 128 on every sphere scene timed (PERF.md).
constexpr int kSphereGroup = 16;

// The sphere table's row groups: `count` groups of kSphereGroup consecutive
// rows in table (Morton) order, each with the box of its rows' swept bounds
// (8 floats a box, as a triangle block's: min xyz, max xyz, 0, 0), padded as
// build_sphere_table pads the JAX kernel's blocks.  The boxes stay in global
// memory, read through the read-only cache (every thread of a warp reads the
// same box), so the shared memory holds as large a sphere table as it did
// before the cull.
struct SphereGroups {
  const float4* boxes = nullptr;
  int count = 0;
};

RTOW_HD float4 load_read_only(const float4* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// nearest_sphere over the groups whose box the ray enters under its
// current best t (the shadow sweep's threshold at first), in table order.
// Inside a group the rows and the strict `<` are nearest_sphere's, and a
// group skipped holds no row hit below the best t (every row's swept bound
// lies in its box), so (t, k) is the brute-force sweep's, bit for bit.
// tally gets the box tests and the rows swept.
RTOW_HD void nearest_sphere_culled(const float4* tbl, const SphereGroups& G,
                                   const Ray& r, float a, float inv_a,
                                   float t_init, float* best_t, int* best_k,
                                   Tally* tally) {
  const float idx = 1.0f / r.dx;
  const float idy = 1.0f / r.dy;
  const float idz = 1.0f / r.dz;
  float bt = t_init;
  int bk = 0;
  tally->sph_boxes += static_cast<unsigned long long>(G.count);
  for (int g = 0; g < G.count; ++g) {
    const float4 box[2] = {load_read_only(G.boxes + 2 * g),
                           load_read_only(G.boxes + 2 * g + 1)};
    if (!box_entered(box, 0, r, idx, idy, idz, bt)) continue;
    tally->sph_rows += static_cast<unsigned long long>(kSphereGroup);
    float gt;
    int gk;
    // The group's rows: nearest_sphere over a table that starts at row
    // g * kSphereGroup, from the best t so far.
    nearest_sphere(tbl + 4 * g * kSphereGroup, kSphereGroup, r, a, inv_a, bt,
                   &gt, &gk);
    if (gt < bt) {
      bt = gt;
      bk = g * kSphereGroup + gk;
    }
  }
  *best_t = bt;
  *best_k = bk;
}

// Moller-Trumbore in the reference's determinant form with its backface cull
// (_mt_rows :661-705, src/common-model.cpp:104-125): whether triangle row k
// is hit at a t in [T_MIN, bt), and that t.  side_mask kKeepSign tests det
// (one-sided), kDropSign |det| (two-sided, :676-679).  The kernels fix the
// mask at compile time, so the AND folds away: read at run time it costs
// an instruction per triangle test.
RTOW_HD bool triangle_t(const float4* tri, int k, const Ray& r, float bt,
                        uint32_t side_mask, float* t) {
  const float4 p0 = tri[4 * k];
  const float4 p1 = tri[4 * k + 1];
  const float4 p2 = tri[4 * k + 2];
  const float e1x = p0.w, e1y = p1.x, e1z = p1.y;
  const float e2x = p1.z, e2y = p1.w, e2z = p2.x;
  const float nxb = e1y * e2z - e1z * e2y;
  const float nyb = e1z * e2x - e1x * e2z;
  const float nzb = e1x * e2y - e1y * e2x;
  const float det = -(r.dx * nxb + r.dy * nyb + r.dz * nzb);
  if (!(sign_masked(det, side_mask) >= kDetMin)) return false;
  const float invdet = 1.0f / det;
  const float aox = r.ox - p0.x;
  const float aoy = r.oy - p0.y;
  const float aoz = r.oz - p0.z;
  const float daox = aoy * r.dz - aoz * r.dy;
  const float daoy = aoz * r.dx - aox * r.dz;
  const float daoz = aox * r.dy - aoy * r.dx;
  const float u = (e2x * daox + e2y * daoy + e2z * daoz) * invdet;
  const float v = -(e1x * daox + e1y * daoy + e1z * daoz) * invdet;
  const float tt = (aox * nxb + aoy * nyb + aoz * nzb) * invdet;
  *t = tt;
  return tt >= kTMin && tt < bt && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

RTOW_HD void sweep_triangle_block(const Tris& T, int b, const Ray& r, int base,
                                  float* bt, int* bk, Tally* tally) {
  const int k0 = b * T.block;
  const int k1 = k0 + T.block < T.count ? k0 + T.block : T.count;
  for (int k = k0; k < k1; ++k) {
    float t;
    if (triangle_t(T.tbl, k, r, *bt, T.side_mask, &t)) {
      *bt = t;
      *bk = base + k;
    }
  }
  if (k1 > k0) tally->tris += static_cast<unsigned long long>(k1 - k0);
}

// Goes on with a sweep's (bt, bk) over the triangle table.  The ray descends
// hypers -> supers -> blocks in table order, slab-testing each box with its
// current bt and skipping every box it does not enter (fixed-order nested
// loops, no stack).  Rows are tested in table order with a strict `<`, so
// the first minimal t wins: the JAX sweep's tie rule.
RTOW_HD void nearest_triangle(const Tris& T, const Ray& r, int base,
                              float* bt, int* bk, Tally* tally) {
  const float idx = 1.0f / r.dx;
  const float idy = 1.0f / r.dy;
  const float idz = 1.0f / r.dz;
  if (T.n_super == 0) {
    for (int b = 0; b < T.n_blocks; ++b) {
      ++tally->boxes;
      if (box_entered(T.boxes, b, r, idx, idy, idz, *bt))
        sweep_triangle_block(T, b, r, base, bt, bk, tally);
    }
    return;
  }
  const int n_top = T.n_hyper > 0 ? T.n_hyper : 1;
  for (int h = 0; h < n_top; ++h) {
    int s0 = 0, s1 = T.n_super;
    if (T.n_hyper > 0) {
      ++tally->boxes;
      if (!box_entered(T.hypers, h, r, idx, idy, idz, *bt)) continue;
      s0 = h * kSuper;
      s1 = s0 + kSuper;
    }
    for (int s = s0; s < s1; ++s) {
      ++tally->boxes;
      if (!box_entered(T.supers, s, r, idx, idy, idz, *bt)) continue;
      for (int b = s * kSuper; b < (s + 1) * kSuper; ++b) {
        ++tally->boxes;
        if (box_entered(T.boxes, b, r, idx, idy, idz, *bt))
          sweep_triangle_block(T, b, r, base, bt, bk, tally);
      }
    }
  }
}

// ---- the warp's cooperative triangle sweep (K3's warp form) --------------

// How a ray sweeps the triangle table: one thread alone (nearest_triangle)
// or the 32 threads of a warp together (nearest_triangle_warp).  A
// compile-time policy of bounce_lane_t and next_event, so the per-thread
// instances compile as they did before the warp form existed.
enum class Sweep { kThread, kWarp };

// One warp's 32 lanes on one ray.  On the card each thread is a lane, and
// every thread of the warp makes each call with the same arguments; a host
// build plays the 32 lanes one after another in one thread, so the same
// sweep runs under g++.
struct Warp {
  static constexpr int kLanes = 32;

  // The mask of the lanes j for which pred(j) holds.
  template <class Pred>
  RTOW_HD static uint32_t ballot(Pred pred) {
#ifdef __CUDA_ARCH__
    const int j = static_cast<int>(threadIdx.x & 31u);
    return __ballot_sync(0xFFFFFFFFu, pred(j));
#else
    uint32_t m = 0;
    for (int j = 0; j < kLanes; ++j)
      if (pred(j)) m |= 1u << j;
    return m;
#endif
  }

  // The least (t, k) over the lanes, by t and then by k, into every lane's
  // *t, *k: lane_best(j, &t, &k) gives lane j's pair.  The t are never NaN
  // where it matters (a NaN pair never wins, so it stays where every pair
  // is NaN), and the order of the comparisons does not change the result.
  template <class Best>
  RTOW_HD static void least(Best lane_best, float* t, int* k) {
#ifdef __CUDA_ARCH__
    lane_best(static_cast<int>(threadIdx.x & 31u), t, k);
    for (int off = 16; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(0xFFFFFFFFu, *t, off);
      const int ok = __shfl_xor_sync(0xFFFFFFFFu, *k, off);
      if (ot < *t || (ot == *t && ok < *k)) {
        *t = ot;
        *k = ok;
      }
    }
#else
    for (int j = 0; j < kLanes; ++j) {
      float lt;
      int lk;
      lane_best(j, &lt, &lk);
      if (j == 0 || lt < *t || (lt == *t && lk < *k)) {
        *t = lt;
        *k = lk;
      }
    }
#endif
  }
};

// Whether the calling thread writes its lane's shared results (sums into
// shared or global memory, a lane's outputs, counters): every thread of a
// per-thread form; in the warp form, where the 32 threads hold the same
// results, lane 0 alone; a host build's one thread.
template <Sweep kSweep>
RTOW_HD bool writes_lane() {
#ifdef __CUDA_ARCH__
  if constexpr (kSweep == Sweep::kWarp) return (threadIdx.x & 31u) == 0u;
#endif
  return true;
}

RTOW_HD int lowest_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(static_cast<int>(m)) - 1;
#else
  return __builtin_ctz(m);
#endif
}

constexpr int kNoRow = 0x7FFFFFFF;  // a lane's row where it hit nothing

// sweep_triangle_block by the warp: lane j tests rows k0 + j, k0 + 32 + j,
// ... (neighbouring lanes read neighbouring rows), each against its own
// best from the block's starting bt, and the least (t, row) over the lanes
// is the block's.  That is the serial loop's (bt, bk): its strict `<` keeps
// the first minimal t in table order.  The rows are counted once, for the
// ray.
RTOW_HD void sweep_triangle_block_warp(const Tris& T, int b, const Ray& r,
                                       int base, float* bt, int* bk,
                                       Tally* tally) {
  const int k0 = b * T.block;
  const int k1 = k0 + T.block < T.count ? k0 + T.block : T.count;
  const float bt0 = *bt;
  float t;
  int k;
  Warp::least(
      [&](int j, float* lt, int* lk) {
        *lt = bt0;
        *lk = kNoRow;
        for (int row = k0 + j; row < k1; row += Warp::kLanes) {
          float tt;
          if (triangle_t(T.tbl, row, r, *lt, T.side_mask, &tt)) {
            *lt = tt;
            *lk = row;
          }
        }
      },
      &t, &k);
  if (k != kNoRow) {
    *bt = t;
    *bk = base + k;
  }
  if (k1 > k0) tally->tris += static_cast<unsigned long long>(k1 - k0);
}

// Calls visit(c), in table order, for each child c in [c0, c1) of one level
// (boxes `box`) that the ray enters under the then-current *bt, as
// nearest_triangle's loops do, and counts the level's box tests.  The warp
// slab-tests 32 children at once against *bt and visits the candidates in
// order, testing a candidate again where a sweep has lowered *bt since: a
// box the ray does not enter under some bt it does not enter under a
// smaller one either, so the candidates hold every child the serial loop
// enters, and the second test is the serial test.
template <class Visit>
RTOW_HD void visit_entered(const float4* box, int c0, int c1, const Ray& r,
                           float idx, float idy, float idz, float* bt,
                           Tally* tally, Visit visit) {
  tally->boxes += static_cast<unsigned long long>(c1 - c0);
  for (int g0 = c0; g0 < c1; g0 += Warp::kLanes) {
    const float bt0 = *bt;
    uint32_t m = Warp::ballot([&](int j) {
      return g0 + j < c1 && box_entered(box, g0 + j, r, idx, idy, idz, bt0);
    });
    while (m != 0u) {
      const int c = g0 + lowest_bit(m);
      m &= m - 1u;
      if (*bt == bt0 || box_entered(box, c, r, idx, idy, idz, *bt)) visit(c);
    }
  }
}

// nearest_triangle by the 32 lanes of a warp on one ray: the same descent
// in the same table order, the same boxes tested and the same blocks swept
// (every hyper; 16 supers per entered hyper; 16 blocks per entered super),
// so (bt, bk) and the counts are the serial walk's, bit for bit.  A thread
// of the serial form reads ~1,000 rows one after another; a lane here reads
// one in 32 of them, neighbouring lanes' rows side by side.
RTOW_HD void nearest_triangle_warp(const Tris& T, const Ray& r, int base,
                                   float* bt, int* bk, Tally* tally) {
  const float idx = 1.0f / r.dx;
  const float idy = 1.0f / r.dy;
  const float idz = 1.0f / r.dz;
  const auto blocks = [&](int b) {
    sweep_triangle_block_warp(T, b, r, base, bt, bk, tally);
  };
  if (T.n_super == 0) {
    visit_entered(T.boxes, 0, T.n_blocks, r, idx, idy, idz, bt, tally, blocks);
    return;
  }
  const auto supers = [&](int s) {
    visit_entered(T.boxes, s * kSuper, (s + 1) * kSuper, r, idx, idy, idz, bt,
                  tally, blocks);
  };
  if (T.n_hyper == 0) {
    visit_entered(T.supers, 0, T.n_super, r, idx, idy, idz, bt, tally, supers);
    return;
  }
  visit_entered(T.hypers, 0, T.n_hyper, r, idx, idy, idz, bt, tally,
                [&](int h) {
                  visit_entered(T.supers, h * kSuper, (h + 1) * kSuper, r,
                                idx, idy, idz, bt, tally, supers);
                });
}

// The triangle sweep under policy kSweep.
template <Sweep kSweep>
RTOW_HD void nearest_triangle_by(const Tris& T, const Ray& r, int base,
                                 float* bt, int* bk, Tally* tally) {
  if constexpr (kSweep == Sweep::kWarp)
    nearest_triangle_warp(T, r, base, bt, bk, tally);
  else
    nearest_triangle(T, r, base, bt, bk, tally);
}

// A triangle's hit record (_hit_basics :922-972): t re-derived as
// (ao . n) / det, the unit normal cross(e1, e2) (1 / sqrt, not rsqrtf, which
// is not IEEE), always front-facing (src/common-model.cpp:122).  Without
// `cull` the normal is turned toward the ray (:965-968).
RTOW_HD Hit triangle_hit_record(const float4* tri, int k, const Ray& r,
                                bool cull = true) {
  const float4 p0 = tri[4 * k];
  const float4 p1 = tri[4 * k + 1];
  const float4 p2 = tri[4 * k + 2];
  const float e1x = p0.w, e1y = p1.x, e1z = p1.y;
  const float e2x = p1.z, e2y = p1.w, e2z = p2.x;
  const float nxb = e1y * e2z - e1z * e2y;
  const float nyb = e1z * e2x - e1x * e2z;
  const float nzb = e1x * e2y - e1y * e2x;
  const float det = -(r.dx * nxb + r.dy * nyb + r.dz * nzb);
  const float det_safe = fabsf(det) > kEps12 ? det : 1.0f;
  Hit e;
  e.t = ((r.ox - p0.x) * nxb + (r.oy - p0.y) * nyb + (r.oz - p0.z) * nzb) /
        det_safe;
  e.px = r.ox + e.t * r.dx;
  e.py = r.oy + e.t * r.dy;
  e.pz = r.oz + e.t * r.dz;
  const float l2 = nxb * nxb + nyb * nyb + nzb * nzb;
  const float inv = l2 > 0.0f ? 1.0f / sqrtf(l2) : 0.0f;
  e.nx = nxb * inv;
  e.ny = nyb * inv;
  e.nz = nzb * inv;
  if (!cull && !(r.dx * e.nx + r.dy * e.ny + r.dz * e.nz < 0.0f)) {
    e.nx = e.nx * -1.0f;
    e.ny = e.ny * -1.0f;
    e.nz = e.nz * -1.0f;
  }
  e.front = true;
  return e;
}

RTOW_HD Material triangle_material(const float4* tri, int k) {
  const float4 p2 = tri[4 * k + 2];
  const float4 p3 = tri[4 * k + 3];
  return Material{p2.y, p2.z, p2.w, p3.x, p3.y, p3.z};
}

// The reference's sky gradient seen along d (blue is 1).
RTOW_HD void sky_color(float dy, float a, float* skyr, float* skyg) {
  const float sky_t = 0.5f * (dy * (1.0f / sqrtf(a)) + 1.0f);
  *skyr = 1.0f - sky_t + sky_t * 0.5f;
  *skyg = 1.0f - sky_t + sky_t * 0.7f;
}

// Background colour of the miss (use_sky: the sky, else the flat bg).
struct Background {
  int use_sky;
  float r, g, b;
};

// A scattering hit's new state: origin at the hit point, the scattered
// direction, throughput times the attenuation, one more bounce.
RTOW_HD void advance(float* s, int* bounce, const Hit& e, const Scatter& sc) {
  s[0] = e.px;
  s[1] = e.py;
  s[2] = e.pz;
  s[3] = sc.dx;
  s[4] = sc.dy;
  s[5] = sc.dz;
  s[7] = s[7] * sc.atr;
  s[8] = s[8] * sc.atg;
  s[9] = s[9] * sc.atb;
  ++*bounce;
}

// ---- the lit features (K1) -----------------------------------------------

constexpr int kLitCols = 14;  // floats per light or volume row
constexpr float kEmissive = 3.0f;
constexpr float kChecker = 4.0f;
constexpr float kNoise = 5.0f;
constexpr double kPiD = 3.14159265358979323846;
// The JAX kernel's float64 constants rounded to float32.
constexpr float kPi = static_cast<float>(kPiD);
constexpr float kInvPi = static_cast<float>(1.0 / kPiD);
constexpr float kHalfInvPi = static_cast<float>(0.5 / kPiD);
constexpr float kQuarterInvPi = static_cast<float>(0.25 / kPiD);
constexpr float kShadowFrac = static_cast<float>(1.0 - 1e-3);
constexpr float kLightFar = 1e30f;
constexpr int kRRStart = 3;      // rtow_tpu/ops/integrator.py:55-57
constexpr float kRRPMin = 0.05f;

// The lit features of a render.  rows: the (n_lights + n_vol) x 14 light
// rows then volume rows (the volumes from vol_row0); light_kinds and
// vol_kinds: 2 bits per row, light 0 sphere / 1 triangle, volume 0 sphere /
// 1 box / 2 rotated box.
struct Lit {
  const float* rows;
  int emissive, n_lights, checker, n_vol, vol_row0, roulette;
  uint32_t light_kinds, vol_kinds;
#ifdef RTOW_STAGED_FRAMES
  // Null, or each volume's (cos, sin) of its rotation (column 7), staged
  // once a block by K5 (grad_bwd.cu defines RTOW_STAGED_FRAMES), which
  // reads them in every interval and interval adjoint (stage_frames).  The
  // other kernels keep neither the field nor the branch in vol_frame.
  const float* frames = nullptr;
#endif
};

// max(x, lo) as torch.clamp(x, min=lo) takes it (a NaN stays NaN).
RTOW_HD float at_least(float x, float lo) { return x < lo ? lo : x; }

// sqrt(x) where x > floor, else 0 (the JAX code's double-where guard).
RTOW_HD float sqrt_pos(float x, float floor_v) {
  return x <= floor_v ? 0.0f : sqrtf(x);
}

// -- textures (models/materials.py) --

RTOW_HD float hash01(int xi, int yi, int zi) {
  uint32_t h = static_cast<uint32_t>(xi) * 0x9E3779B1u ^
               static_cast<uint32_t>(yi) * 0x85EBCA77u ^
               static_cast<uint32_t>(zi) * 0xC2B2AE3Du;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return static_cast<float>(static_cast<int>(h >> 8)) * kInv24;
}

RTOW_HD float lerp(float a, float b, float t) { return a + (b - a) * t; }

RTOW_HD float value_noise(float px, float py, float pz) {
  const float ix = floorf(px), iy = floorf(py), iz = floorf(pz);
  const float fx = px - ix, fy = py - iy, fz = pz - iz;
  const float ux = fx * fx * (3.0f - 2.0f * fx);
  const float uy = fy * fy * (3.0f - 2.0f * fy);
  const float uz = fz * fz * (3.0f - 2.0f * fz);
  const int xi = static_cast<int>(ix), yi = static_cast<int>(iy);
  const int zi = static_cast<int>(iz);
  const float c00 = lerp(hash01(xi, yi, zi), hash01(xi + 1, yi, zi), ux);
  const float c10 =
      lerp(hash01(xi, yi + 1, zi), hash01(xi + 1, yi + 1, zi), ux);
  const float c01 =
      lerp(hash01(xi, yi, zi + 1), hash01(xi + 1, yi, zi + 1), ux);
  const float c11 =
      lerp(hash01(xi, yi + 1, zi + 1), hash01(xi + 1, yi + 1, zi + 1), ux);
  return lerp(lerp(c00, c10, uy), lerp(c01, c11, uy), uz);
}

RTOW_HD float marble_t(float px, float py, float pz, float scale) {
  float turb = value_noise(px * scale, py * scale, pz * scale) +
               0.5f * value_noise(px * scale * 2.0f + 17.0f, py * scale * 2.0f,
                                  pz * scale * 2.0f) +
               0.25f * value_noise(px * scale * 4.0f,
                                   py * scale * 4.0f + 31.0f,
                                   pz * scale * 4.0f);
  turb = turb / 1.75f;
  return 0.5f * (1.0f + sinf(scale * pz + 10.0f * turb));
}

// The winner sphere's material with its texture applied at the hit point.
RTOW_HD Material textured(const float4* tbl, int k, Material m, float px,
                          float py, float pz) {
  const float4 q3 = tbl[4 * k + 3];
  if (m.kind == kChecker) {
    const float sp = sinf(m.ir * px) * sinf(m.ir * py) * sinf(m.ir * pz);
    if (sp < 0.0f) {
      m.alr = q3.y;
      m.alg = q3.z;
      m.alb = q3.w;
    }
  } else if (m.kind == kNoise) {
    const float t = marble_t(px, py, pz, m.ir);
    m.alr = m.alr + (q3.y - m.alr) * t;
    m.alg = m.alg + (q3.z - m.alg) * t;
    m.alb = m.alb + (q3.w - m.alb) * t;
  }
  return m;
}

RTOW_HD bool is_diffuse(float kind) {
  return kind == 0.0f || kind == kChecker || kind == kNoise;
}

// -- lights (ops/lights.py) --

struct LightSample {
  float dx, dy, dz, t, w0, w1, w2, pdf;
};

// Light `k` sampled from p (sample_light_dirs, for the picked light).
RTOW_HD LightSample sample_light(const Lit& L, int k, float u1, float u2,
                                 float px, float py, float pz, float tm) {
  const float* q = L.rows + kLitCols * k;
  const float n = static_cast<float>(L.n_lights);
  LightSample ls;
  if (((L.light_kinds >> (2 * k)) & 3u) == 0u) {  // sphere
    const float cx = q[1] + tm * q[4];
    const float cy = q[2] + tm * q[5];
    const float cz = q[3] + tm * q[6];
    const float r2 = q[7] * q[7];
    const float tox = cx - px, toy = cy - py, toz = cz - pz;
    const float d2 = tox * tox + toy * toy + toz * toz;
    const float d = sqrtf(at_least(d2, 1e-12f));
    const float inv_d = 1.0f / d;
    const float wx = tox * inv_d, wy = toy * inv_d, wz = toz * inv_d;
    const float cos_max = sqrt_pos(1.0f - r2 / at_least(d2, 1e-12f), 0.0f);
    const float cos_t = 1.0f - u1 * (1.0f - cos_max);
    const float sin_t = sqrt_pos(1.0f - cos_t * cos_t, 1e-12f);
    const float phi = kTwoPi * u2;
    // Branchless orthonormal basis around w (Frisvad / Duff).
    const float sign = wz >= 0.0f ? 1.0f : -1.0f;
    const float a = -1.0f / (sign + wz);
    const float b = wx * wy * a;
    const float ux = 1.0f + sign * wx * wx * a, uy = sign * b, uz = -sign * wx;
    const float vx = b, vy = sign + wy * wy * a, vz = -wy;
    const float cp = cosf(phi), sp = sinf(phi);
    ls.dx = cp * sin_t * ux + sp * sin_t * vx + cos_t * wx;
    ls.dy = cp * sin_t * uy + sp * sin_t * vy + cos_t * wy;
    ls.dz = cp * sin_t * uz + sp * sin_t * vz + cos_t * wz;
    const float oc_d = -(tox * ls.dx + toy * ls.dy + toz * ls.dz);
    const float disc = oc_d * oc_d - (d2 - r2);
    const float t_k = -oc_d - sqrt_pos(disc, 0.0f);
    const bool ok = d2 > r2 && disc > 0.0f;
    const float geo = ok ? 2.0f * (1.0f - cos_max) * n : 0.0f;
    ls.pdf = ok ? 1.0f / at_least(kTwoPi * (1.0f - cos_max) * n, 1e-12f)
                : 0.0f;
    ls.t = at_least(t_k, 1e-4f);
    ls.w0 = q[11] * geo;
    ls.w1 = q[12] * geo;
    ls.w2 = q[13] * geo;
  } else {  // triangle: a uniform point on it
    const float e1x = q[4], e1y = q[5], e1z = q[6];
    const float e2x = q[7], e2y = q[8], e2z = q[9];
    const float area = q[10];
    const float su = sqrtf(at_least(u1, 1e-12f));
    const float bu = 1.0f - su;
    const float bv = u2 * su;
    const float qx = q[1] + bu * e1x + bv * e2x;
    const float qy = q[2] + bu * e1y + bv * e2y;
    const float qz = q[3] + bu * e1z + bv * e2z;
    const float tox = qx - px, toy = qy - py, toz = qz - pz;
    const float d2 = tox * tox + toy * toy + toz * toz;
    const float d = sqrtf(at_least(d2, 1e-12f));
    const float inv_d = 1.0f / d;
    ls.dx = tox * inv_d;
    ls.dy = toy * inv_d;
    ls.dz = toz * inv_d;
    const float nx = e1y * e2z - e1z * e2y;
    const float ny = e1z * e2x - e1x * e2z;
    const float nz = e1x * e2y - e1y * e2x;
    const float nlen = sqrtf(at_least(nx * nx + ny * ny + nz * nz, 1e-24f));
    const float cos_a = -(ls.dx * nx + ls.dy * ny + ls.dz * nz) / nlen;
    const bool ok = cos_a > 1e-6f;
    const float geo =
        ok ? cos_a * area * n / (kPi * at_least(d2, 1e-12f)) : 0.0f;
    ls.pdf = ok ? d2 / at_least(cos_a * area * n, 1e-12f) : 0.0f;
    ls.t = at_least(d, 1e-4f);
    ls.w0 = q[11] * geo;
    ls.w1 = q[12] * geo;
    ls.w2 = q[13] * geo;
  }
  return ls;
}

// The light strategy's pdf of direction d from o when the path's nearest
// hit is at t_hit (light_pdf_toward): each matching light's, summed in
// light order.
RTOW_HD float light_pdf_toward(const Lit& L, const Ray& r, float t_hit) {
  const float n = static_cast<float>(L.n_lights);
  const float dlen =
      sqrtf(at_least(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz, 1e-24f));
  const float inv_l = 1.0f / dlen;
  const float ux = r.dx * inv_l, uy = r.dy * inv_l, uz = r.dz * inv_l;
  const float th = t_hit * dlen;
  float pdf = 0.0f;
  for (int k = 0; k < L.n_lights; ++k) {
    const float* q = L.rows + kLitCols * k;
    bool ok;
    float t_k, pdf_k;
    if (((L.light_kinds >> (2 * k)) & 3u) == 0u) {
      const float cx = q[1] + r.tm * q[4];
      const float cy = q[2] + r.tm * q[5];
      const float cz = q[3] + r.tm * q[6];
      const float r2 = q[7] * q[7];
      const float tox = cx - r.ox, toy = cy - r.oy, toz = cz - r.oz;
      const float d2 = tox * tox + toy * toy + toz * toz;
      const float oc_d = -(tox * ux + toy * uy + toz * uz);
      const float disc = oc_d * oc_d - (d2 - r2);
      t_k = -oc_d - sqrt_pos(disc, 0.0f);
      const float cos_max = sqrt_pos(1.0f - r2 / at_least(d2, 1e-12f), 0.0f);
      ok = d2 > r2 && disc > 0.0f && t_k > 0.0f;
      pdf_k = 1.0f / at_least(kTwoPi * (1.0f - cos_max) * n, 1e-12f);
    } else {  // Moller-Trumbore, front side only
      const float e1x = q[4], e1y = q[5], e1z = q[6];
      const float e2x = q[7], e2y = q[8], e2z = q[9];
      const float px_ = uy * e2z - uz * e2y;
      const float py_ = uz * e2x - ux * e2z;
      const float pz_ = ux * e2y - uy * e2x;
      const float det = e1x * px_ + e1y * py_ + e1z * pz_;
      const float inv = 1.0f / (fabsf(det) < 1e-12f ? 1.0f : det);
      const float sx = r.ox - q[1], sy = r.oy - q[2], sz = r.oz - q[3];
      const float u = (sx * px_ + sy * py_ + sz * pz_) * inv;
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float v = (ux * qx + uy * qy + uz * qz) * inv;
      t_k = (e2x * qx + e2y * qy + e2z * qz) * inv;
      ok = det >= 1e-6f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
           t_k > 0.0f;
      const float nx = e1y * e2z - e1z * e2y;
      const float ny = e1z * e2x - e1x * e2z;
      const float nz = e1x * e2y - e1y * e2x;
      const float nlen = sqrtf(at_least(nx * nx + ny * ny + nz * nz, 1e-24f));
      const float cos_a = -(ux * nx + uy * ny + uz * nz) / nlen;
      pdf_k = (t_k * t_k) / at_least(cos_a * q[10] * n, 1e-12f);
    }
    if (ok && fabsf(t_k - th) <= 1e-3f * at_least(th, 1.0f)) pdf = pdf + pdf_k;
  }
  return pdf;
}

// -- media (ops/volumes.py) --

// The (cos, sin) of volume k's rotation about y (its row q's column 7):
// from L.frames where K5 staged them, else derived here by the same
// cosf / sinf, so both give the same bits.
RTOW_HD void vol_frame(const Lit& L, int k, const float* q, float* c,
                       float* sn) {
#ifdef RTOW_STAGED_FRAMES
  if (L.frames != nullptr) {
    *c = L.frames[2 * k];
    *sn = L.frames[2 * k + 1];
    return;
  }
#else
  (void)L;
  (void)k;
#endif
  *c = cosf(q[7]);
  *sn = sinf(q[7]);
}

#ifdef RTOW_STAGED_FRAMES
// Writes each volume's (cos, sin) to frames (2 n_vol floats) for
// vol_frame, one volume per thread of `threads` from thread t; the caller
// then points L->frames at them once every thread has written.
RTOW_HD void stage_frames(const Lit& L, float* frames, int t, int threads) {
  for (int k = t; k < L.n_vol; k += threads) {
    const float* q = L.rows + kLitCols * (L.vol_row0 + k);
    frames[2 * k] = cosf(q[7]);
    frames[2 * k + 1] = sinf(q[7]);
  }
}
#endif

// The boundary interval [t0, t1] of volume k along the ray; false where the
// ray misses it.
RTOW_HD bool vol_interval(const Lit& L, int k, float ox, float oy, float oz,
                          float dx, float dy, float dz, float* t0, float* t1) {
  const float* q = L.rows + kLitCols * (L.vol_row0 + k);
  const uint32_t kind = (L.vol_kinds >> (2 * k)) & 3u;
  if (kind == 0u) {  // sphere
    const float ocx = ox - q[0], ocy = oy - q[1], ocz = oz - q[2];
    const float a = dx * dx + dy * dy + dz * dz;
    const float h = ocx * dx + ocy * dy + ocz * dz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - q[3] * q[3];
    const float disc = h * h - a * c;
    const float sq = disc <= 0.0f ? 0.0f : sqrtf(disc);
    const float inv_a = 1.0f / at_least(a, 1e-24f);
    *t0 = (-h - sq) * inv_a;
    *t1 = (-h + sq) * inv_a;
    return disc > 0.0f;
  }
  if (kind == 2u) {  // rotated box: the ray into the box's local frame
    float c, sn;
    vol_frame(L, k, q, &c, &sn);
    const float wx = ox - q[11], wy = oy - q[12], wz = oz - q[13];
    ox = c * wx - sn * wz;
    oz = sn * wx + c * wz;
    oy = wy;
    const float ldx = c * dx - sn * dz;
    dz = sn * dx + c * dz;
    dx = ldx;
  }
  float lo[3], hi[3];
  const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
  for (int i = 0; i < 3; ++i) {
    const float di = fabsf(d[i]) < 1e-24f ? (d[i] < 0.0f ? -1e-24f : 1e-24f)
                                          : d[i];
    const float inv = 1.0f / di;
    const float ta = (q[i] - o[i]) * inv, tb = (q[3 + i] - o[i]) * inv;
    lo[i] = ta < tb ? ta : tb;
    hi[i] = ta > tb ? ta : tb;
  }
  const float m01 = lo[0] > lo[1] ? lo[0] : lo[1];
  const float n01 = hi[0] < hi[1] ? hi[0] : hi[1];
  *t0 = m01 > lo[2] ? m01 : lo[2];
  *t1 = n01 < hi[2] ? n01 : hi[2];
  return *t0 < *t1;
}

// exp(-sum sigma * overlap) along [0, t_max] of the ray (the shadow ray's
// medium attenuation).
RTOW_HD float transmittance(const Lit& L, const Ray& r, float t_max) {
  const float dlen =
      sqrtf(at_least(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz, 1e-24f));
  float tau = 0.0f;
  for (int k = 0; k < L.n_vol; ++k) {
    float t0, t1;
    if (vol_interval(L, k, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, &t0, &t1)) {
      const float t_in = at_least(t0, 0.0f);
      const float t_out = t1 < t_max ? t1 : t_max;
      const float overlap = at_least(t_out - t_in, 0.0f);
      tau = tau + L.rows[kLitCols * (L.vol_row0 + k) + 6] * overlap * dlen;
    }
  }
  return expf(-tau);
}

// The free-flight volume event before t_surf (sample_volume_event): the
// volume where one lands (-1 where none does), at t_v, with the medium's
// albedo.
RTOW_HD int volume_event(const Lit& L, const Ray& r, uint32_t lane,
                         uint32_t salt, float t_surf, float* t_v,
                         float* alb) {
  const float dlen =
      sqrtf(at_least(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz, 1e-24f));
  float tv = kLightFar;
  int win = -1;
  for (int k = 0; k < L.n_vol; ++k) {
    float t0, t1;
    const bool valid =
        vol_interval(L, k, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, &t0, &t1);
    const float* q = L.rows + kLitCols * (L.vol_row0 + k);
    const float t_in = at_least(t0, 1e-3f);
    const float t_out = t1 < t_surf ? t1 : t_surf;
    const float sigma = q[6] < 1e-12f ? 1e-12f : q[6];
    const float u = uniform(lane, salt, 16 + k);
    const float t_k = t_in + -logf(at_least(u, 1e-12f)) / sigma / dlen;
    if (valid && t_in < t_out && t_k < t_out && t_k < tv) {
      tv = t_k;
      win = k;
      alb[0] = q[8];
      alb[1] = q[9];
      alb[2] = q[10];
    }
  }
  *t_v = tv;
  return win;
}

// Next-event estimation from p (_nee_contrib): a light sample, its MIS
// balance weight against the scatter strategy (the cosine pdf at a
// surface, the isotropic phase 1 / (4 pi) at a volume event), the shadow
// ray's medium transmittance, and the shadow sweep from t_init = the
// light's distance less 0.1%.  Adds the contribution to s[10..12] where
// the shadow ray gets through; tally counts the shadow ray.  kSweep: how the
// shadow ray sweeps the triangles; kCull: how it sweeps the spheres (the
// groups sg under SphereCull::kGroups).
template <bool kTris, Sweep kSweep = Sweep::kThread,
          SphereCull kCull = SphereCull::kNone>
RTOW_HD void next_event(const float4* tbl, int npad, const Tris& tris,
                        const Lit& L, float* s, float px, float py, float pz,
                        float nx, float ny, float nz, float nar, float nag,
                        float nab, bool volume, uint32_t lane, uint32_t salt,
                        Tally* tally, SphereGroups sg = SphereGroups{}) {
  const float pick = uniform(lane, salt, 8);
  const float u1 = uniform(lane, salt, 9);
  const float u2 = uniform(lane, salt, 10);
  int k = static_cast<int>(pick * static_cast<float>(L.n_lights));
  if (k > L.n_lights - 1) k = L.n_lights - 1;
  const LightSample ls = sample_light(L, k, u1, u2, px, py, pz, s[6]);
  const float thresh = ls.t * kShadowFrac;
  const float cos_t = at_least(nx * ls.dx + ny * ls.dy + nz * ls.dz, 0.0f);
  const float phase = volume ? kQuarterInvPi : cos_t * kInvPi;
  float factor = volume ? 0.25f : cos_t;
  const float w_l = ls.pdf / at_least(ls.pdf + phase, kEps12);
  const Ray sr{px, py, pz, ls.dx, ls.dy, ls.dz, s[6]};
  if (L.n_vol > 0) factor = factor * transmittance(L, sr, ls.t);
  const float cw = factor * w_l;
  const float cr = s[7] * nar * ls.w0 * cw;
  const float cg = s[8] * nag * ls.w1 * cw;
  const float cb = s[9] * nab * ls.w2 * cw;
  const float la = sr.dx * sr.dx + sr.dy * sr.dy + sr.dz * sr.dz;
  ++tally->shadows;
  float st;
  int sk;
  if constexpr (kCull == SphereCull::kGroups)
    nearest_sphere_culled(tbl, sg, sr, la, 1.0f / la, thresh, &st, &sk,
                          tally);
  else
    nearest_sphere(tbl, npad, sr, la, 1.0f / la, thresh, &st, &sk);
  if constexpr (kTris)
    nearest_triangle_by<kSweep>(tris, sr, npad, &st, &sk, tally);
  if (st >= thresh) {
    s[10] = s[10] + cr;
    s[11] = s[11] + cg;
    s[12] = s[12] + cb;
  }
}

// Russian roulette on a scattered lane's post-increment bounce count (from
// RR_START on): survive with p = clamp(max throughput channel, RR_PMIN, 1),
// boosted by 1 / p.  Returns whether the lane survives.
RTOW_HD bool roulette(const Lit& L, float* s, int bounce, uint32_t lane,
                      uint32_t salt) {
  if (!L.roulette || bounce <= kRRStart) return true;
  float p = s[7] > s[8] ? s[7] : s[8];
  p = p > s[9] ? p : s[9];
  p = p < kRRPMin ? kRRPMin : (p > 1.0f ? 1.0f : p);
  if (uniform(lane, salt, 11) >= p) return false;
  const float boost = 1.0f / p;
  s[7] = s[7] * boost;
  s[8] = s[8] * boost;
  s[9] = s[9] * boost;
  return true;
}

// ---- one bounce ----------------------------------------------------------

// One intersect-and-shade step of a live lane.  s holds the 13 floats
// (ox oy oz dx dy dz tm tpr tpg tpb rr rg rb) and is updated in place: a
// miss adds throughput * background to the radiance and retires the lane,
// a hit at depth retires it (depth is checked after the hit), any other hit
// scatters.  Returns the alive code: 0 dead, else alive (the JAX kernels'
// `can`).  kTris adds the triangle sweep of `tris` after the spheres;
// `tally` gets its work.
//
// kLit adds the rest of _bounce_core (K1's lit instances), each feature
// acting where the runtime L says the scene has it: the volume event, which
// overrides the surface and the sky (at depth it absorbs); textures;
// emission, which lands before the depth test and retires the lane, its
// MIS weight from the light pdf toward the hit when the previous bounce
// scattered diffusely (from_diffuse); NEE at diffuse hits and volume
// events; roulette.  The alive code is then 2 after a diffuse or volume
// scatter under NEE.  Without kLit the code is the plain bounce's.
//
// kSweep: the triangle sweeps (the main one and the shadow rays') one
// thread alone, or the 32 threads of a warp on the same lane (K3's warp
// form: every thread of the warp runs the whole bounce on the same inputs
// and ends with the same s, bounce and tally).  kCull: the sphere sweeps
// over every row, or over the groups sg whose box the ray enters (K1).
template <bool kTris, bool kLit = false, Sweep kSweep = Sweep::kThread,
          SphereCull kCull = SphereCull::kNone>
RTOW_HD int bounce_lane_t(const float4* tbl, int npad, const Tris& tris,
                          float* s, int* bounce, uint32_t lane, uint32_t salt,
                          int max_depth, const Background& bg, Tally* tally,
                          const Lit& L = Lit{}, bool from_diffuse = false,
                          SphereGroups sg = SphereGroups{}) {
  const Ray r{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float inv_a = 1.0f / a;
  float best_t;
  int best_k;
  if constexpr (kCull == SphereCull::kGroups)
    nearest_sphere_culled(tbl, sg, r, a, inv_a, kBig, &best_t, &best_k,
                          tally);
  else
    nearest_sphere(tbl, npad, r, a, inv_a, &best_t, &best_k);
  if constexpr (kTris)
    nearest_triangle_by<kSweep>(tris, r, npad, &best_t, &best_k, tally);
  const bool nee = kLit && L.n_lights > 0;
  if constexpr (kLit) {
    float v_t, v_alb[3];
    if (L.n_vol > 0 &&
        volume_event(L, r, lane, salt, best_t, &v_t, v_alb) >= 0) {
      if (*bounce >= max_depth) return 0;
      const float vpx = r.ox + v_t * r.dx;
      const float vpy = r.oy + v_t * r.dy;
      const float vpz = r.oz + v_t * r.dz;
      if (nee)
        next_event<kTris, kSweep, kCull>(tbl, npad, tris, L, s, vpx, vpy,
                                         vpz, 0.0f, 0.0f, 0.0f, v_alb[0],
                                         v_alb[1], v_alb[2], true, lane, salt,
                                         tally, sg);
      const Draws w = draw_scatter(lane, salt);
      s[0] = vpx;
      s[1] = vpy;
      s[2] = vpz;
      s[3] = w.uvx * 0.5f;  // isotropic: |d| / (2 pi) is then 1 / (4 pi)
      s[4] = w.uvy * 0.5f;
      s[5] = w.uvz * 0.5f;
      s[7] = s[7] * v_alb[0];
      s[8] = s[8] * v_alb[1];
      s[9] = s[9] * v_alb[2];
      ++*bounce;
      return roulette(L, s, *bounce, lane, salt) ? (nee ? 2 : 1) : 0;
    }
  }
  if (!(best_t < kBig)) {
    float skyr = bg.r, skyg = bg.g, skyb = bg.b;
    if (bg.use_sky) {
      sky_color(r.dy, a, &skyr, &skyg);
      skyb = 1.0f;
    }
    s[10] = s[10] + s[7] * skyr;
    s[11] = s[11] + s[8] * skyg;
    s[12] = s[12] + s[9] * skyb;
    return 0;
  }
  if constexpr (!kLit) {
    if (*bounce >= max_depth) return 0;
  }
  Hit e;
  Material m;
  if (kTris && best_k >= npad) {
    e = triangle_hit_record(tris.tbl, best_k - npad, r,
                            tris.side_mask == kKeepSign);
    m = triangle_material(tris.tbl, best_k - npad);
  } else {
    e = hit_record(tbl, best_k, best_t, r, a, inv_a);
    m = sphere_material(tbl, best_k);
    if (kLit && L.checker) m = textured(tbl, best_k, m, e.px, e.py, e.pz);
  }
  bool diffuse = false;
  if constexpr (kLit) {
    if (L.emissive && m.kind == kEmissive) {
      // Emission lands at any depth; a diffuse-scattered ray's is
      // weighted against the light sample (balance heuristic).
      float w_emit = 1.0f;
      if (nee && from_diffuse) {
        const float p_l = light_pdf_toward(L, r, e.t);
        const float p_b = sqrtf(a) * kHalfInvPi;
        w_emit = p_b / at_least(p_b + p_l, kEps12);
      }
      s[10] = s[10] + s[7] * m.alr * w_emit;
      s[11] = s[11] + s[8] * m.alg * w_emit;
      s[12] = s[12] + s[9] * m.alb * w_emit;
      return 0;
    }
    if (*bounce >= max_depth) return 0;
    diffuse = is_diffuse(m.kind);
    if (nee && diffuse)
      next_event<kTris, kSweep, kCull>(tbl, npad, tris, L, s, e.px, e.py,
                                       e.pz, e.nx, e.ny, e.nz, m.alr, m.alg,
                                       m.alb, false, lane, salt, tally, sg);
  }
  advance(s, bounce, e, scatter(m, e, r, a, draw_scatter(lane, salt)));
  if constexpr (kLit) {
    if (!roulette(L, s, *bounce, lane, salt)) return 0;
  }
  return nee && diffuse ? 2 : 1;
}

}  // namespace rtow
