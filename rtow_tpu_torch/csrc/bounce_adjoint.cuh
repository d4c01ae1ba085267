// The adjoint (reverse-mode derivative) of rtow::bounce_lane_t for one lane:
// the body of K5, rtow_tpu/ops/pallas_grad.py:_grad_bwd_kernel (:224).
//
// The JAX kernel replays the bounce from its saved input state and calls
// jax.vjp on _shade_pure inside the kernel.  CUDA has no vjp, so the shade's
// adjoint is written out here step by step, in reverse order of the forward
// in bounce.cuh, in three parts: the shade (from the output cotangents to
// those of the hit point, the normal, the input direction and the material),
// then the hit record of the winner's kind, a sphere's or a triangle's (to
// the input state and the winner's table row).  The replay calls the
// forward's own functions -- nearest_sphere, then nearest_triangle where the
// scene has triangles -- so every discrete decision (the winner, hit or
// miss, which root, the face, TIR and Schlick's choice, k > 0, the material)
// is the forward's, bit for bit.  Discrete decisions carry no cotangent.
// Tie rules are autograd's on the plain version
// (rtow_tpu_torch/ops/megakernel.py:shade), which are JAX's: min(cos_raw, 1)
// passes half the cotangent at cos_raw == 1; |r| passes sign(r), 0 at r = 0;
// a select passes nothing to the branch it drops, so the guarded square
// roots and divisions of the forward take no part.

#pragma once

#include "bounce.cuh"

namespace rtow {

// Cotangents of a sphere's winner row: c0 (3), dc (3), r, albedo (3), fuzz,
// ir -- table columns 0..11 (the kind column's is 0).
constexpr int kParamGrads = 12;
// Cotangents of a triangle's winner row: v0 (3), e1 (3), e2 (3), albedo (3),
// fuzz, ir -- table columns 0..13 (the kind column's and column 15's are 0).
constexpr int kTriParamGrads = 14;

// What the shade's adjoint hands to the hit record's: the cotangents of the
// hit point (the new origin), of the unit normal against the ray, of the
// input direction and of a = |d|^2, and of the winner's material.
struct ShadeGrad {
  float px, py, pz;
  float nx, ny, nz;
  float dx, dy, dz, a;
  float alr, alg, alb, fuzz, ir;
};

// The adjoint of the shade of a scattering hit: the new state
// (p, the scattered direction, tp * attenuation) from the hit record e, the
// material m, the scatter sc and the draws w.  Writes the throughput's
// input cotangents gin[7..9]; returns the rest.
RTOW_HD ShadeGrad shade_adjoint(const Hit& e, const Material& m,
                                const Scatter& sc, const Draws& w,
                                const Ray& r, const float* s, const float* G,
                                float* gin) {
  ShadeGrad g{};
  const bool is_diel = m.kind == kDielectric;

  // ---- tp' = tp * at; at = albedo unless dielectric -----------------
  gin[7] = G[7] * sc.atr;
  gin[8] = G[8] * sc.atg;
  gin[9] = G[9] * sc.atb;
  g.alr = is_diel ? 0.0f : G[7] * s[7];
  g.alg = is_diel ? 0.0f : G[8] * s[8];
  g.alb = is_diel ? 0.0f : G[9] * s[9];

  // ---- d' = the scattered direction ----------------------------------
  const float gsx = G[3], gsy = G[4], gsz = G[5];
  if (m.kind == kMetal) {  // d - ddn2 * n + fuzz * u, ddn2 = 2 (d . n)
    const float ddn2 = 2.0f * (r.dx * e.nx + r.dy * e.ny + r.dz * e.nz);
    const float g_dn = -2.0f * (gsx * e.nx + gsy * e.ny + gsz * e.nz);
    g.dx += gsx + g_dn * e.nx;
    g.dy += gsy + g_dn * e.ny;
    g.dz += gsz + g_dn * e.nz;
    g.nx += g_dn * r.dx - ddn2 * gsx;
    g.ny += g_dn * r.dy - ddn2 * gsy;
    g.nz += g_dn * r.dz - ddn2 * gsz;
    g.fuzz = gsx * w.uvx + gsy * w.uvy + gsz * w.uvz;
  } else if (is_diel) {  // (reflect or refract of ud) + fuzz * u
    g.fuzz = gsx * w.uvx + gsy * w.uvy + gsz * w.uvz;
    float gux = 0.0f, guy = 0.0f, guz = 0.0f, g_ratio = 0.0f, g_cos = 0.0f;
    if (sc.must_reflect) {  // ud - udn2 * n, udn2 = 2 (ud . n)
      const float udn2 =
          2.0f * (sc.udx * e.nx + sc.udy * e.ny + sc.udz * e.nz);
      const float g_un = -2.0f * (gsx * e.nx + gsy * e.ny + gsz * e.nz);
      gux += gsx + g_un * e.nx;
      guy += gsy + g_un * e.ny;
      guz += gsz + g_un * e.nz;
      g.nx += g_un * sc.udx - udn2 * gsx;
      g.ny += g_un * sc.udy - udn2 * gsy;
      g.nz += g_un * sc.udz - udn2 * gsz;
    } else {  // ratio * ud + mm * n, mm = ratio * cos_t - sqk
      const float mm = sc.ratio * sc.cos_t - sc.sqk;
      const float g_m = gsx * e.nx + gsy * e.ny + gsz * e.nz;
      g_ratio += gsx * sc.udx + gsy * sc.udy + gsz * sc.udz;
      gux += sc.ratio * gsx;
      guy += sc.ratio * gsy;
      guz += sc.ratio * gsz;
      g.nx += mm * gsx;
      g.ny += mm * gsy;
      g.nz += mm * gsz;
      g_ratio += g_m * sc.cos_t;
      g_cos += g_m * sc.ratio;
      if (sc.k_ok) {  // sqk = sqrt(k), k = 1 - ratio^2 (1 - cos_t^2)
        const float g_k = -g_m * 0.5f / sc.sqk;
        const float sn = 1.0f - sc.cos_t * sc.cos_t;
        g_ratio += -g_k * sn * 2.0f * sc.ratio;
        g_cos += g_k * sc.ratio * sc.ratio * 2.0f * sc.cos_t;
      }
    }
    // cos_t = min(cos_raw, 1); cos_raw = -(ud . n)
    const float g_cr = sc.cos_raw < 1.0f    ? g_cos
                       : sc.cos_raw == 1.0f ? 0.5f * g_cos
                                            : 0.0f;
    gux -= g_cr * e.nx;
    guy -= g_cr * e.ny;
    guz -= g_cr * e.nz;
    g.nx -= g_cr * sc.udx;
    g.ny -= g_cr * sc.udy;
    g.nz -= g_cr * sc.udz;
    // ratio = 1 / ir_safe on the front face, else ir_safe;
    // ir_safe = ir where ir > 0, else the constant 1
    const float g_irs = e.front ? -g_ratio * (sc.ratio * sc.ratio) : g_ratio;
    g.ir = m.ir > 0.0f ? g_irs : 0.0f;
    // ud = d * inv_dlen, inv_dlen = 1 / sqrt(a)
    g.dx += gux * sc.inv_dlen;
    g.dy += guy * sc.inv_dlen;
    g.dz += guz * sc.inv_dlen;
    const float g_inv = gux * r.dx + guy * r.dy + guz * r.dz;
    g.a += -0.5f * g_inv * sc.inv_dlen * sc.inv_dlen * sc.inv_dlen;
  } else {  // Lambertian: n + u, or n where degenerate -- either way n
    g.nx += gsx;
    g.ny += gsy;
    g.nz += gsz;
  }
  g.px = G[0];  // o' = p
  g.py = G[1];
  g.pz = G[2];
  return g;
}

// The sphere's hit record (hit_record) and its sweep's root: from the
// shade's cotangents to the input state's gin[0..6] and the winner row's
// gw[0..11].
RTOW_HD void sphere_hit_adjoint(const float4* tbl, int k, const Hit& e,
                                const Ray& r, float a, float inv_a,
                                const ShadeGrad& g, const float* G,
                                float* gin, float* gw) {
  const float4 q0 = tbl[4 * k];
  const float4 q1 = tbl[4 * k + 1];
  float gdx = g.dx, gdy = g.dy, gdz = g.dz, ga = g.a;

  // ---- n = flip * (p - c) / r_abs; r_abs = |r|, or the constant 1 -----
  const float gn0x = g.nx * e.flip;
  const float gn0y = g.ny * e.flip;
  const float gn0z = g.nz * e.flip;
  const float gpx = g.px + gn0x / e.r_abs;
  const float gpy = g.py + gn0y / e.r_abs;
  const float gpz = g.pz + gn0z / e.r_abs;
  float gcx = -gn0x / e.r_abs;
  float gcy = -gn0y / e.r_abs;
  float gcz = -gn0z / e.r_abs;
  const float g_rabs = -(gn0x * (e.px - e.cx) + gn0y * (e.py - e.cy) +
                         gn0z * (e.pz - e.cz)) /
                       (e.r_abs * e.r_abs);
  float gr = e.r > 0.0f ? g_rabs : e.r < 0.0f ? -g_rabs : 0.0f;

  // ---- p = o + t * d ---------------------------------------------------
  float gox = gpx, goy = gpy, goz = gpz;
  gdx += gpx * e.t;
  gdy += gpy * e.t;
  gdz += gpz * e.t;
  const float gt = gpx * r.dx + gpy * r.dy + gpz * r.dz;

  // ---- t = (-h -/+ sq) * inv_a, the root the sweep chose ---------------
  const float num = e.near_root ? -e.h - e.sq : -e.h + e.sq;
  const float g_num = gt * inv_a;
  ga -= gt * num * inv_a * inv_a;
  float gh = -g_num;
  const float g_sq = e.near_root ? -g_num : g_num;
  // sq = sqrt(disc) where disc > 0, else sqrt of the constant 1
  const float g_disc = e.disc > 0.0f ? g_sq * 0.5f / e.sq : 0.0f;
  // disc = h^2 - a * cc
  gh += 2.0f * e.h * g_disc;
  ga -= e.cc * g_disc;
  const float g_cc = -a * g_disc;
  // cc = |oc|^2 - r^2, h = oc . d
  const float gocx = 2.0f * e.ocx * g_cc + gh * r.dx;
  const float gocy = 2.0f * e.ocy * g_cc + gh * r.dy;
  const float gocz = 2.0f * e.ocz * g_cc + gh * r.dz;
  gr -= 2.0f * e.r * g_cc;
  gdx += gh * e.ocx;
  gdy += gh * e.ocy;
  gdz += gh * e.ocz;
  // oc = o - c
  gox += gocx;
  goy += gocy;
  goz += gocz;
  gcx -= gocx;
  gcy -= gocy;
  gcz -= gocz;

  // ---- c = c0 + tm * dc; a = |d|^2 -------------------------------------
  gw[0] = gcx;
  gw[1] = gcy;
  gw[2] = gcz;
  gw[3] = gcx * r.tm;
  gw[4] = gcy * r.tm;
  gw[5] = gcz * r.tm;
  gw[6] = gr;
  gw[7] = g.alr;
  gw[8] = g.alg;
  gw[9] = g.alb;
  gw[10] = g.fuzz;
  gw[11] = g.ir;
  gin[6] = G[6] + (gcx * q0.w + gcy * q1.x + gcz * q1.y);
  gin[0] = gox;
  gin[1] = goy;
  gin[2] = goz;
  gin[3] = gdx + 2.0f * r.dx * ga;
  gin[4] = gdy + 2.0f * r.dy * ga;
  gin[5] = gdz + 2.0f * r.dz * ga;
}

// The triangle's hit record (triangle_hit_record): from the shade's
// cotangents to the input state's gin[0..5] (tm passes through: gin[6] keeps
// G[6]) and the winner row's gw[0..13].  Forward:
//   nb = e1 x e2, det = -(d . nb), det_safe = det where |det| > 1e-12 else 1,
//   t = ((o - v0) . nb) / det_safe, p = o + t d,
//   n = nb * inv, inv = 1 / sqrt(|nb|^2) where |nb|^2 > 0 else 0;
// the face is always the front one (flip 1).
RTOW_HD void triangle_hit_adjoint(const float4* tri, int k, const Hit& e,
                                  const Ray& r, const ShadeGrad& g,
                                  float* gin, float* gw) {
  const float4 p0 = tri[4 * k];
  const float4 p1 = tri[4 * k + 1];
  const float4 p2 = tri[4 * k + 2];
  const float e1x = p0.w, e1y = p1.x, e1z = p1.y;
  const float e2x = p1.z, e2y = p1.w, e2z = p2.x;
  const float nxb = e1y * e2z - e1z * e2y;
  const float nyb = e1z * e2x - e1x * e2z;
  const float nzb = e1x * e2y - e1y * e2x;
  const float det = -(r.dx * nxb + r.dy * nyb + r.dz * nzb);
  const bool det_ok = fabsf(det) > kEps12;
  const float det_safe = det_ok ? det : 1.0f;
  const float aox = r.ox - p0.x, aoy = r.oy - p0.y, aoz = r.oz - p0.z;
  const float l2 = nxb * nxb + nyb * nyb + nzb * nzb;
  const float inv = l2 > 0.0f ? 1.0f / sqrtf(l2) : 0.0f;

  // ---- n = nb * inv ----------------------------------------------------
  float gnbx = g.nx * inv, gnby = g.ny * inv, gnbz = g.nz * inv;
  if (l2 > 0.0f) {  // inv = l2^(-1/2): d inv / d l2 = -inv^3 / 2
    const float g_inv = g.nx * nxb + g.ny * nyb + g.nz * nzb;
    const float g_l2 = -0.5f * g_inv * inv * inv * inv;
    gnbx += 2.0f * nxb * g_l2;
    gnby += 2.0f * nyb * g_l2;
    gnbz += 2.0f * nzb * g_l2;
  }

  // ---- p = o + t * d ---------------------------------------------------
  float gox = g.px, goy = g.py, goz = g.pz;
  float gdx = g.dx + g.px * e.t;
  float gdy = g.dy + g.py * e.t;
  float gdz = g.dz + g.pz * e.t;
  const float gt = g.px * r.dx + g.py * r.dy + g.pz * r.dz;

  // ---- t = num / det_safe, num = ao . nb ---------------------------------
  const float g_num = gt / det_safe;
  // det_safe passes its cotangent to det only where |det| > 1e-12
  const float g_det = det_ok ? -g_num * e.t : 0.0f;
  // det = -(d . nb)
  gdx -= g_det * nxb;
  gdy -= g_det * nyb;
  gdz -= g_det * nzb;
  gnbx -= g_det * r.dx;
  gnby -= g_det * r.dy;
  gnbz -= g_det * r.dz;
  // num = ao . nb, ao = o - v0
  gnbx += g_num * aox;
  gnby += g_num * aoy;
  gnbz += g_num * aoz;
  const float gaox = g_num * nxb, gaoy = g_num * nyb, gaoz = g_num * nzb;
  gox += gaox;
  goy += gaoy;
  goz += gaoz;

  // ---- nb = e1 x e2: g_e1 = e2 x g_nb, g_e2 = g_nb x e1 ------------------
  gw[0] = -gaox;
  gw[1] = -gaoy;
  gw[2] = -gaoz;
  gw[3] = e2y * gnbz - e2z * gnby;
  gw[4] = e2z * gnbx - e2x * gnbz;
  gw[5] = e2x * gnby - e2y * gnbx;
  gw[6] = gnby * e1z - gnbz * e1y;
  gw[7] = gnbz * e1x - gnbx * e1z;
  gw[8] = gnbx * e1y - gnby * e1x;
  gw[9] = g.alr;
  gw[10] = g.alg;
  gw[11] = g.alb;
  gw[12] = g.fuzz;
  gw[13] = g.ir;
  gin[0] = gox;
  gin[1] = goy;
  gin[2] = goz;
  gin[3] = gdx + 2.0f * r.dx * g.a;
  gin[4] = gdy + 2.0f * r.dy * g.a;
  gin[5] = gdz + 2.0f * r.dz * g.a;
}

// Replays bounce_lane_t<kTris> for a live lane from its saved input state s
// (13 floats, bounce) and maps the output cotangents G (13, in the order of
// s) to the input cotangents gin (13) and the winner row's cotangents gw
// (kParamGrads for a sphere, kTriParamGrads for a triangle, in its table's
// column order).  Returns the winner's id (spheres 0 .. npad - 1, triangles
// npad + row), or -1 where the bounce read no row (a miss, a hit at depth);
// gw is written only for a winner.  kTris sweeps `tris` after the spheres,
// counting its work in `tally`, as the forward does.
template <bool kTris>
RTOW_HD int bounce_lane_adjoint_t(const float4* tbl, int npad,
                                  const Tris& tris, const float* s,
                                  int bounce, uint32_t lane, uint32_t salt,
                                  int max_depth, const Background& bg,
                                  const float* G, float* gin, float* gw,
                                  Tally* tally) {
  for (int j = 0; j < kCont; ++j) gin[j] = G[j];
  const Ray r{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float inv_a = 1.0f / a;
  float best_t;
  int best_k;
  nearest_sphere(tbl, npad, r, a, inv_a, &best_t, &best_k);
  if constexpr (kTris) nearest_triangle(tris, r, npad, &best_t, &best_k, tally);

  if (!(best_t < kBig)) {  // miss: rad' = rad + tp * background
    float skyr = bg.r, skyg = bg.g, skyb = bg.b;
    if (bg.use_sky) {
      sky_color(r.dy, a, &skyr, &skyg);
      skyb = 1.0f;
    }
    gin[7] += G[10] * skyr;
    gin[8] += G[11] * skyg;
    gin[9] += G[12] * skyb;
    if (bg.use_sky) {
      // skyr = 1 - st + st * 0.5, skyg = 1 - st + st * 0.7,
      // st = 0.5 * (dy * inv_len + 1), inv_len = 1 / sqrt(a)
      const float g_skyr = G[10] * s[7];
      const float g_skyg = G[11] * s[8];
      const float g_st = -g_skyr + g_skyr * 0.5f - g_skyg + g_skyg * 0.7f;
      const float g_u = 0.5f * g_st;
      const float inv_len = 1.0f / sqrtf(a);
      gin[4] += g_u * inv_len;
      const float ga = -0.5f * (g_u * r.dy) * inv_len * inv_len * inv_len;
      gin[3] += 2.0f * r.dx * ga;
      gin[4] += 2.0f * r.dy * ga;
      gin[5] += 2.0f * r.dz * ga;
    }
    return -1;
  }
  if (bounce >= max_depth) return -1;  // retired: the identity

  const bool is_tri = kTris && best_k >= npad;
  Hit e;
  Material m;
  if (is_tri) {
    e = triangle_hit_record(tris.tbl, best_k - npad, r);
    m = triangle_material(tris.tbl, best_k - npad);
  } else {
    e = hit_record(tbl, best_k, best_t, r, a, inv_a);
    m = sphere_material(tbl, best_k);
  }
  const Draws w = draw_scatter(lane, salt);
  const Scatter sc = scatter(m, e, r, a, w);
  const ShadeGrad g = shade_adjoint(e, m, sc, w, r, s, G, gin);
  if (is_tri)
    triangle_hit_adjoint(tris.tbl, best_k - npad, e, r, g, gin, gw);
  else
    sphere_hit_adjoint(tbl, best_k, e, r, a, inv_a, g, G, gin, gw);
  return best_k;
}

}  // namespace rtow
