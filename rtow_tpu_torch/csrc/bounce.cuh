// One bounce of one lane for sphere scenes: device code shared by the port's
// kernels (megakernel.cu = K1, grad_fwd.cu = K4, grad_bwd.cu = K5).
//
// The sphere, sky and three-material subset of
// rtow_tpu/ops/pallas_megakernel.py:_bounce_core (:1329, "K2"): the counter
// RNG (_mix, _uniform :112-131), the nearest-sphere sweep (_sweep_all :390),
// the hit record re-derived from the winner's parameters (_hit_basics :891),
// the Lambertian / metal / dielectric scatter and the sky (_shade_pure :998),
// and the scatter draws (_draw_scatter :1225).  The plain PyTorch version is
// nearest_sphere + shade in rtow_tpu_torch/ops/megakernel.py.
//
// Numbers: float32 throughout; the kernels are built with -fmad=false and
// IEEE division and square root, so every operation here rounds as in the
// plain version and both take the same discrete decisions.
//
// The table is (npad, 16) float32 rows read as 4 float4:
//   c0x c0y c0z dcx | dcy dcz r alr | alg alb fuzz ir | kind al2r al2g al2b
// Padding rows have r = 0 and a far-away center, so they are never hit.
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

RTOW_HD Scatter scatter(const float4* tbl, int k, const Hit& e, const Ray& r,
                        float a, const Draws& w) {
  const float4 q1 = tbl[4 * k + 1];
  const float4 q2 = tbl[4 * k + 2];
  const float kind = tbl[4 * k + 3].x;
  const float fuzz = q2.z;
  Scatter s;
  s.atr = q1.w;
  s.atg = q2.x;
  s.atb = q2.y;
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
    const float ir = q2.w;
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

// One intersect-and-shade step of a live lane.  s holds the 13 floats
// (ox oy oz dx dy dz tm tpr tpg tpb rr rg rb) and is updated in place: a
// miss adds throughput * background to the radiance and retires the lane,
// a hit at depth retires it (depth is checked after the hit), any other hit
// scatters.  Returns whether the lane goes on (the JAX kernels' `can`).
RTOW_HD bool bounce_lane(const float4* tbl, int npad, float* s, int* bounce,
                         uint32_t lane, uint32_t salt, int max_depth,
                         const Background& bg) {
  const Ray r{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float inv_a = 1.0f / a;
  float best_t;
  int best_k;
  nearest_sphere(tbl, npad, r, a, inv_a, &best_t, &best_k);
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
  const Hit e = hit_record(tbl, best_k, best_t, r, a, inv_a);
  const Scatter sc = scatter(tbl, best_k, e, r, a, draw_scatter(lane, salt));
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
  return true;
}

}  // namespace rtow
