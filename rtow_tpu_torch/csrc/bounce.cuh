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
// rtow_tpu_torch/ops/megakernel.py.  K4 and K5 take spheres only
// (bounce_lane); K1 and K3 take triangles too (bounce_lane_t<true>).
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

// Nearest hit over every table row.  Rows are tested in table order with a
// strict `<`, so the first minimal t wins: the JAX sweep's tie rule
// (first minimum inside a 128-row block, strictly smaller across blocks).
RTOW_HD void nearest_sphere(const float4* tbl, int npad, const Ray& r,
                            float a, float inv_a, float* best_t, int* best_k) {
  float bt = kBig;
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

RTOW_HD Scatter scatter(const float4* tbl, int k, const Hit& e, const Ray& r,
                        float a, const Draws& w) {
  return scatter(sphere_material(tbl, k), e, r, a, w);
}

// ---- triangles -----------------------------------------------------------

// The triangle table and its cull hierarchy: per-level AABBs, 8 floats a
// box (min xyz, max xyz, 0, 0): blocks of `block` rows, supers of kSuper
// blocks, hypers of kSuper supers (n_super / n_hyper 0 where a level is
// absent).  Rows past `count` are padding: zero, never hit, not tested.
struct Tris {
  const float4* tbl;
  const float4* boxes;
  const float4* supers;
  const float4* hypers;
  int n_blocks, n_super, n_hyper, block, count;
};

// The sweep's work, counted per thread for the kernels' stats.
struct Tally {
  unsigned long long boxes = 0, tris = 0;
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

// Moller-Trumbore in the reference's determinant form with its backface cull
// (_mt_rows :661-705, src/common-model.cpp:104-125): whether triangle row k
// is hit at a t in [T_MIN, bt), and that t.
RTOW_HD bool triangle_t(const float4* tri, int k, const Ray& r, float bt,
                        float* t) {
  const float4 p0 = tri[4 * k];
  const float4 p1 = tri[4 * k + 1];
  const float4 p2 = tri[4 * k + 2];
  const float e1x = p0.w, e1y = p1.x, e1z = p1.y;
  const float e2x = p1.z, e2y = p1.w, e2z = p2.x;
  const float nxb = e1y * e2z - e1z * e2y;
  const float nyb = e1z * e2x - e1x * e2z;
  const float nzb = e1x * e2y - e1y * e2x;
  const float det = -(r.dx * nxb + r.dy * nyb + r.dz * nzb);
  if (!(det >= kDetMin)) return false;
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
    if (triangle_t(T.tbl, k, r, *bt, &t)) {
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

// A triangle's hit record (_hit_basics :922-972): t re-derived as
// (ao . n) / det, the unit normal cross(e1, e2) (1 / sqrt, not rsqrtf, which
// is not IEEE), always front-facing (src/common-model.cpp:122).
RTOW_HD Hit triangle_hit_record(const float4* tri, int k, const Ray& r) {
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

// One intersect-and-shade step of a live lane.  s holds the 13 floats
// (ox oy oz dx dy dz tm tpr tpg tpb rr rg rb) and is updated in place: a
// miss adds throughput * background to the radiance and retires the lane,
// a hit at depth retires it (depth is checked after the hit), any other hit
// scatters.  Returns whether the lane goes on (the JAX kernels' `can`).
// kTris adds the triangle sweep of `tris` after the spheres; `tally` gets
// its work.
template <bool kTris>
RTOW_HD bool bounce_lane_t(const float4* tbl, int npad, const Tris& tris,
                           float* s, int* bounce, uint32_t lane, uint32_t salt,
                           int max_depth, const Background& bg,
                           Tally* tally) {
  const Ray r{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float inv_a = 1.0f / a;
  float best_t;
  int best_k;
  nearest_sphere(tbl, npad, r, a, inv_a, &best_t, &best_k);
  if constexpr (kTris) nearest_triangle(tris, r, npad, &best_t, &best_k, tally);
  if (!(best_t < kBig)) {
    float skyr = bg.r, skyg = bg.g, skyb = bg.b;
    if (bg.use_sky) {
      sky_color(r.dy, a, &skyr, &skyg);
      skyb = 1.0f;
    }
    s[10] = s[10] + s[7] * skyr;
    s[11] = s[11] + s[8] * skyg;
    s[12] = s[12] + s[9] * skyb;
    return false;
  }
  if (*bounce >= max_depth) return false;
  if constexpr (kTris) {
    if (best_k >= npad) {
      const Hit e = triangle_hit_record(tris.tbl, best_k - npad, r);
      advance(s, bounce, e,
              scatter(triangle_material(tris.tbl, best_k - npad), e, r, a,
                      draw_scatter(lane, salt)));
      return true;
    }
  }
  const Hit e = hit_record(tbl, best_k, best_t, r, a, inv_a);
  advance(s, bounce, e, scatter(tbl, best_k, e, r, a, draw_scatter(lane, salt)));
  return true;
}

// The sphere-only bounce of K4 and K5.
RTOW_HD bool bounce_lane(const float4* tbl, int npad, float* s, int* bounce,
                         uint32_t lane, uint32_t salt, int max_depth,
                         const Background& bg) {
  return bounce_lane_t<false>(tbl, npad, Tris{}, s, bounce, lane, salt,
                              max_depth, bg, nullptr);
}

}  // namespace rtow
