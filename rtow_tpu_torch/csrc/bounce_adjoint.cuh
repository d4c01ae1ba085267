// The adjoint (reverse-mode derivative) of rtow::bounce_lane for one lane:
// the body of K5, rtow_tpu/ops/pallas_grad.py:_grad_bwd_kernel (:224).
//
// The JAX kernel replays the bounce from its saved input state and calls
// jax.vjp on _shade_pure inside the kernel.  CUDA has no vjp, so the shade's
// adjoint is written out here step by step, in reverse order of the forward
// in bounce.cuh.  The replay calls the forward's own functions, so every
// discrete decision (the winner, hit or miss, which root, the face, TIR and
// Schlick's choice, k > 0, the material) is the forward's, bit for bit.
// Discrete decisions carry no cotangent.  Tie rules are autograd's on the
// plain version (rtow_tpu_torch/ops/megakernel.py:shade), which are JAX's:
// min(cos_raw, 1) passes half the cotangent at cos_raw == 1; |r| passes
// sign(r), 0 at r = 0; a select passes nothing to the branch it drops, so
// the guarded square roots of the forward take no part.

#pragma once

#include "bounce.cuh"

namespace rtow {

// Cotangents of a winner row: c0 (3), dc (3), r, albedo (3), fuzz, ir --
// table columns 0..11 (the kind column's is 0).
constexpr int kParamGrads = 12;

// Replays bounce_lane for a live lane from its saved input state s (13
// floats, bounce) and maps the output cotangents G (13, in the order of s)
// to the input cotangents gin (13) and the winner row's parameter
// cotangents gw.  Returns the winner's row, or -1 where the bounce read no
// row (a miss, a hit at depth); gw is written only for a winner.
RTOW_HD int bounce_lane_adjoint(const float4* tbl, int npad, const float* s,
                                int bounce, uint32_t lane, uint32_t salt,
                                int max_depth, const Background& bg,
                                const float* G, float* gin, float* gw) {
  for (int j = 0; j < kCont; ++j) gin[j] = G[j];
  const Ray r{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float inv_a = 1.0f / a;
  float best_t;
  int best_k;
  nearest_sphere(tbl, npad, r, a, inv_a, &best_t, &best_k);

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

  const Hit e = hit_record(tbl, best_k, best_t, r, a, inv_a);
  const Draws w = draw_scatter(lane, salt);
  const Scatter sc = scatter(tbl, best_k, e, r, a, w);
  const float4 q0 = tbl[4 * best_k];
  const float4 q1 = tbl[4 * best_k + 1];
  const float4 q2 = tbl[4 * best_k + 2];
  const float kind = tbl[4 * best_k + 3].x;
  const bool is_diel = kind == kDielectric;

  // ---- tp' = tp * at; at = albedo unless dielectric -----------------
  gin[7] = G[7] * sc.atr;
  gin[8] = G[8] * sc.atg;
  gin[9] = G[9] * sc.atb;
  gw[7] = is_diel ? 0.0f : G[7] * s[7];
  gw[8] = is_diel ? 0.0f : G[8] * s[8];
  gw[9] = is_diel ? 0.0f : G[9] * s[9];

  // ---- d' = the scattered direction ----------------------------------
  const float gsx = G[3], gsy = G[4], gsz = G[5];
  float gnx = 0.0f, gny = 0.0f, gnz = 0.0f;  // of the flipped normal
  float gdx = 0.0f, gdy = 0.0f, gdz = 0.0f;  // of the input direction
  float ga = 0.0f;                           // of a = |d|^2
  float gfuzz = 0.0f, gir = 0.0f;
  if (kind == kMetal) {  // d - ddn2 * n + fuzz * u, ddn2 = 2 (d . n)
    const float ddn2 = 2.0f * (r.dx * e.nx + r.dy * e.ny + r.dz * e.nz);
    const float g_dn = -2.0f * (gsx * e.nx + gsy * e.ny + gsz * e.nz);
    gdx += gsx + g_dn * e.nx;
    gdy += gsy + g_dn * e.ny;
    gdz += gsz + g_dn * e.nz;
    gnx += g_dn * r.dx - ddn2 * gsx;
    gny += g_dn * r.dy - ddn2 * gsy;
    gnz += g_dn * r.dz - ddn2 * gsz;
    gfuzz = gsx * w.uvx + gsy * w.uvy + gsz * w.uvz;
  } else if (is_diel) {  // (reflect or refract of ud) + fuzz * u
    gfuzz = gsx * w.uvx + gsy * w.uvy + gsz * w.uvz;
    float gux = 0.0f, guy = 0.0f, guz = 0.0f, g_ratio = 0.0f, g_cos = 0.0f;
    if (sc.must_reflect) {  // ud - udn2 * n, udn2 = 2 (ud . n)
      const float udn2 =
          2.0f * (sc.udx * e.nx + sc.udy * e.ny + sc.udz * e.nz);
      const float g_un = -2.0f * (gsx * e.nx + gsy * e.ny + gsz * e.nz);
      gux += gsx + g_un * e.nx;
      guy += gsy + g_un * e.ny;
      guz += gsz + g_un * e.nz;
      gnx += g_un * sc.udx - udn2 * gsx;
      gny += g_un * sc.udy - udn2 * gsy;
      gnz += g_un * sc.udz - udn2 * gsz;
    } else {  // ratio * ud + m * n, m = ratio * cos_t - sqk
      const float m = sc.ratio * sc.cos_t - sc.sqk;
      const float g_m = gsx * e.nx + gsy * e.ny + gsz * e.nz;
      g_ratio += gsx * sc.udx + gsy * sc.udy + gsz * sc.udz;
      gux += sc.ratio * gsx;
      guy += sc.ratio * gsy;
      guz += sc.ratio * gsz;
      gnx += m * gsx;
      gny += m * gsy;
      gnz += m * gsz;
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
    gnx -= g_cr * sc.udx;
    gny -= g_cr * sc.udy;
    gnz -= g_cr * sc.udz;
    // ratio = 1 / ir_safe on the front face, else ir_safe;
    // ir_safe = ir where ir > 0, else the constant 1
    const float g_irs = e.front ? -g_ratio * (sc.ratio * sc.ratio) : g_ratio;
    gir = q2.w > 0.0f ? g_irs : 0.0f;
    // ud = d * inv_dlen, inv_dlen = 1 / sqrt(a)
    gdx += gux * sc.inv_dlen;
    gdy += guy * sc.inv_dlen;
    gdz += guz * sc.inv_dlen;
    const float g_inv = gux * r.dx + guy * r.dy + guz * r.dz;
    ga += -0.5f * g_inv * sc.inv_dlen * sc.inv_dlen * sc.inv_dlen;
  } else {  // Lambertian: n + u, or n where degenerate -- either way n
    gnx += gsx;
    gny += gsy;
    gnz += gsz;
  }

  // ---- n = flip * (p - c) / r_abs; r_abs = |r|, or the constant 1 -----
  const float gn0x = gnx * e.flip;
  const float gn0y = gny * e.flip;
  const float gn0z = gnz * e.flip;
  float gpx = G[0] + gn0x / e.r_abs;  // o' = p
  float gpy = G[1] + gn0y / e.r_abs;
  float gpz = G[2] + gn0z / e.r_abs;
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
  gw[10] = gfuzz;
  gw[11] = gir;
  gin[6] = G[6] + (gcx * q0.w + gcy * q1.x + gcz * q1.y);
  gin[0] = gox;
  gin[1] = goy;
  gin[2] = goz;
  gin[3] = gdx + 2.0f * r.dx * ga;
  gin[4] = gdy + 2.0f * r.dy * ga;
  gin[5] = gdz + 2.0f * r.dz * ga;
  return best_k;
}

}  // namespace rtow
