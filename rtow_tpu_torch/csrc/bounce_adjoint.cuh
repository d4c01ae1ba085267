// The adjoint (reverse-mode derivative) of rtow::bounce_lane_t for one lane:
// the body of K5, rtow_tpu/ops/pallas_grad.py:_grad_bwd_kernel (:224).
//
// The JAX kernel replays the bounce from its saved input state and calls
// jax.vjp on _nee_contrib + _shade_pure inside the kernel (:376-438).  CUDA
// has no vjp, so the adjoint is written out here step by step, in reverse
// order of the forward in bounce.cuh: the shade (from the output cotangents
// to those of the hit point, the normal, the input direction and the
// material), the lit features where the bounce has them (emission and its
// MIS weight, next-event estimation with the light sample and the shadow
// ray's transmittance, the textures), then the hit record of the winner's
// kind, a sphere's or a triangle's (to the input state and the winner's
// table row); or, where a free-flight event lands first, the volume
// scatter's (pallas_grad.py:317-337: the event's distance, a function of
// the volume's density and boundary and of the ray, and its albedo).  The
// replay calls the forward's own functions -- nearest_sphere, then
// nearest_triangle (or, in K5's warp form, nearest_triangle_warp, the same
// winner bit for bit) where the scene has triangles, volume_event,
// sample_light, the shadow sweep, light_pdf_toward -- so every discrete
// decision (the winner, hit or miss, which root, the face, TIR and
// Schlick's choice, k > 0, the material, the picked light, the shadow ray's
// visibility, which lights match the hit, the checker's cell, which
// volume's event lands first, if any) is the forward's, bit for bit.
// Discrete decisions carry no cotangent.  Tie rules are autograd's on the
// plain version (rtow_tpu_torch/ops/megakernel.py:shade, ops/lights.py,
// ops/volumes.py), which are JAX's but at a clamp tie: min(cos_raw, 1)
// passes half the cotangent at cos_raw == 1, as a box slab's min / max
// does; |r| passes sign(r), 0 at r = 0; at_least(x, lo) passes all of it
// where x >= lo (torch.clamp's rule); a select passes nothing to the
// branch it drops, so the guarded square roots and divisions of the forward
// take no part.
#pragma once

#include "bounce.cuh"

namespace rtow {

// Cotangents of a sphere's winner row: c0 (3), dc (3), r, albedo (3), fuzz,
// ir -- table columns 0..11 (the kind column's is 0); with textures also
// the second colour, columns 13..15.
constexpr int kParamGrads = 12;
constexpr int kTexParamGrads = kCols;
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
  // Summed, and below divided, in the order and form autograd takes on
  // the plain version: the edge columns' cotangent is the difference of
  // g_num ao and g_det d, which cancel (|ao| ~ 60 |p - v0| on a 4k-triangle
  // knot), so a last-bit difference here moves it by ~60 ulp (ROADMAP P4).
  const float gt = g.pz * r.dz + g.py * r.dy + g.px * r.dx;

  // ---- t = num / det_safe, num = ao . nb ---------------------------------
  const float g_num = gt / det_safe;
  // det_safe passes its cotangent to det only where |det| > 1e-12
  const float g_det = det_ok ? -gt * (e.t / det_safe) : 0.0f;
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

// ---- the lit features' adjoints -------------------------------------------

#ifdef __CUDACC__
// add_grouped sums a warp's groups first only where one has at least this
// many threads: below it the shuffles cost more than the contention they
// save.
constexpr int kGroupMin = 4;

// Adds each thread's kN values v to row `key` (key < 0: none), first
// summed over the threads of the warp that have the same row: the lowest
// thread of each such group adds the group's sums, add(c, sum) for each
// non-zero column c of its own row (an atomicAdd).  So a warp whose lanes
// hit a few rows makes a few atomics per column, not 32 contending ones (a
// float atomicAdd to shared memory is a compare-and-swap loop,
// ATOMS.CAST.SPIN, which contending threads repeat); where every group is
// smaller than kGroupMin, each thread adds its own values.  The whole warp
// calls it, converged; the group's values are gathered by shuffles, one
// member a round, in lane order, so only the order of the float sums
// changes.
template <int kN, class Add>
__device__ __forceinline__ void add_grouped(int key, const float* v,
                                            Add add) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const unsigned peers = __match_any_sync(kAll, key);
  const bool lead = __ffs(static_cast<int>(peers)) - 1 == lane;
  // The lead's peers; threads with no row (dead lanes, misses, volume
  // events) form no group, so they never raise the rounds.
  unsigned rest = lead && key >= 0 ? peers & (peers - 1u) : 0u;
  const int rounds = static_cast<int>(
      __reduce_max_sync(kAll, static_cast<unsigned>(__popc(rest))));
  if (rounds < kGroupMin) {  // small groups: each thread adds its own
    if (key >= 0) {
#pragma unroll
      for (int c = 0; c < kN; ++c)
        if (v[c] != 0.0f) add(c, v[c]);
    }
    return;
  }
  float sum[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) sum[c] = v[c];
  for (int i = 0; i < rounds; ++i) {
    const int src = rest != 0u ? __ffs(static_cast<int>(rest)) - 1 : lane;
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      const float x = __shfl_sync(kAll, v[c], src);
      if (rest != 0u) sum[c] += x;
    }
    rest &= rest - 1u;
  }
  if (lead && key >= 0) {
#pragma unroll
    for (int c = 0; c < kN; ++c)
      if (sum[c] != 0.0f) add(c, sum[c]);
  }
}
#endif

// Where a lane adds its light and volume rows' cotangents: the sums g (all
// of L's rows x 14 floats), and whether the lane owns them (own: plain
// adds) or shares them with other threads (atomic adds).  A host build's
// lanes own theirs; K5 decides for its device lanes (grad_bwd.cu).
struct RowSums {
  float* g = nullptr;
  bool own = false;
};

// Adds row `row`'s 14 local cotangents q to its sums: plain adds where
// the lane owns them (a host build always), otherwise atomically (in the
// warp form, where the 32 threads hold the same q, by one thread of the
// warp).
template <Sweep kSweep = Sweep::kThread>
RTOW_HD void add_rows(const RowSums& sums, int row, const float* q) {
  float* g = sums.g + kLitCols * row;
#ifdef __CUDA_ARCH__
  if (kSweep == Sweep::kThread && sums.own) {
    for (int c = 0; c < kLitCols; ++c) g[c] += q[c];
  } else if (writes_lane<kSweep>()) {
    for (int c = 0; c < kLitCols; ++c)
      if (q[c] != 0.0f) atomicAdd(g + c, q[c]);
  }
#else
  for (int c = 0; c < kLitCols; ++c) g[c] += q[c];
#endif
}

// c = a x b: ga += b x gc, gb += gc x a.
RTOW_HD void cross_adjoint(const float* a, const float* b, const float* gc,
                           float* ga, float* gb) {
  ga[0] += b[1] * gc[2] - b[2] * gc[1];
  ga[1] += b[2] * gc[0] - b[0] * gc[2];
  ga[2] += b[0] * gc[1] - b[1] * gc[0];
  gb[0] += gc[1] * a[2] - gc[2] * a[1];
  gb[1] += gc[2] * a[0] - gc[0] * a[2];
  gb[2] += gc[0] * a[1] - gc[1] * a[0];
}

RTOW_HD float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// d2 = |to|^2: adds d2's cotangent g_d2 to to's, g_to += 2 to g_d2.
RTOW_HD void d2_adjoint(const float* to, float g_d2, float* g_to) {
  for (int i = 0; i < 3; ++i) g_to[i] += 2.0f * to[i] * g_d2;
}

// The adjoint of w = to / sqrt(at_least(d2, 1e-12)) (the unit vector toward
// a light point): from g_w to g_to (added) and the cotangent of d2
// (returned).
RTOW_HD float unit_adjoint(const float* to, float d2, const float* g_w,
                           float* g_to) {
  const float d = sqrtf(at_least(d2, 1e-12f));
  const float inv_d = 1.0f / d;
  for (int i = 0; i < 3; ++i) g_to[i] += g_w[i] * inv_d;
  const float g_inv = dot3(g_w, to);
  const float g_dd = -g_inv * inv_d * inv_d;
  return d2 >= 1e-12f ? g_dd * 0.5f / d : 0.0f;
}

// The adjoint of sample_light for the picked light k from p at time tm:
// from the cotangents of the sampled direction gdir, of the pdf g_pdf, of
// the weights g_w (3) and of the light's distance g_t (the shadow ray's
// transmittance reads it; its sweep is a discrete decision) to the point's
// gp (added), the time's *g_tm (added) and the row's gq (14, added).
// Sphere: the cone sample (cos_max through sqrt_pos, the Frisvad basis with
// its sign a constant) and the distance to the sphere along it; triangle:
// the area sample (the point from v0, e1, e2; cos_a; area; d2).
RTOW_HD void sample_light_adjoint(const Lit& L, int k, float u1, float u2,
                                  const float* p, float tm, const float* gdir,
                                  float g_pdf, const float* g_w, float g_t,
                                  float* gp, float* g_tm, float* gq) {
  const float* q = L.rows + kLitCols * k;
  const float n = static_cast<float>(L.n_lights);
  float g_to[3] = {0.0f, 0.0f, 0.0f};
  float g_d2 = 0.0f, g_r2 = 0.0f;
  float gd[3] = {gdir[0], gdir[1], gdir[2]};
  if (((L.light_kinds >> (2 * k)) & 3u) == 0u) {  // sphere
    const float c[3] = {q[1] + tm * q[4], q[2] + tm * q[5], q[3] + tm * q[6]};
    const float r2 = q[7] * q[7];
    const float to[3] = {c[0] - p[0], c[1] - p[1], c[2] - p[2]};
    const float d2 = dot3(to, to);
    const float dd = at_least(d2, 1e-12f);
    const float inv_d = 1.0f / sqrtf(dd);
    const float w[3] = {to[0] * inv_d, to[1] * inv_d, to[2] * inv_d};
    const float cm_arg = 1.0f - r2 / dd;
    const float cos_max = sqrt_pos(cm_arg, 0.0f);
    const float cos_t = 1.0f - u1 * (1.0f - cos_max);
    const float st_arg = 1.0f - cos_t * cos_t;
    const float sin_t = sqrt_pos(st_arg, 1e-12f);
    const float phi = kTwoPi * u2;
    const float sign = w[2] >= 0.0f ? 1.0f : -1.0f;
    const float a = -1.0f / (sign + w[2]);
    const float b = w[0] * w[1] * a;
    const float u[3] = {1.0f + sign * w[0] * w[0] * a, sign * b,
                        -sign * w[0]};
    const float v[3] = {b, sign + w[1] * w[1] * a, -w[1]};
    const float cp = cosf(phi), sp = sinf(phi);
    float dir[3];
    for (int i = 0; i < 3; ++i)
      dir[i] = cp * sin_t * u[i] + sp * sin_t * v[i] + cos_t * w[i];
    const float oc_d = -dot3(to, dir);
    const float disc = oc_d * oc_d - (d2 - r2);
    const bool ok = d2 > r2 && disc > 0.0f;
    const float geo = ok ? 2.0f * (1.0f - cos_max) * n : 0.0f;
    // t = at_least(t_k, 1e-4), t_k = -oc_d - sqrt_pos(disc, 0),
    // disc = oc_d^2 - (d2 - r2), oc_d = -(to . dir)
    if (-oc_d - sqrt_pos(disc, 0.0f) >= 1e-4f) {
      float g_ocd = -g_t;
      if (disc > 0.0f) {
        const float g_disc = -g_t * 0.5f / sqrtf(disc);
        g_ocd += 2.0f * oc_d * g_disc;
        g_d2 -= g_disc;
        g_r2 += g_disc;
      }
      for (int i = 0; i < 3; ++i) {
        g_to[i] -= g_ocd * dir[i];
        gd[i] -= g_ocd * to[i];
      }
    }
    // w_c = emit_c * geo
    float g_geo = 0.0f;
    for (int c = 0; c < 3; ++c) {
      gq[11 + c] += g_w[c] * geo;
      g_geo += g_w[c] * q[11 + c];
    }
    float g_cm = 0.0f;
    if (ok) {
      g_cm -= 2.0f * n * g_geo;
      const float x = kTwoPi * (1.0f - cos_max) * n;  // pdf = 1 / x
      if (x >= 1e-12f) g_cm += kTwoPi * n * g_pdf / (x * x);
    }
    // dir = cp sin_t u + sp sin_t v + cos_t w
    float g_u[3], g_v[3], g_w3[3];
    float g_sin = 0.0f, g_cos = 0.0f;
    for (int i = 0; i < 3; ++i) {
      g_sin += gd[i] * (cp * u[i] + sp * v[i]);
      g_u[i] = gd[i] * cp * sin_t;
      g_v[i] = gd[i] * sp * sin_t;
      g_cos += gd[i] * w[i];
      g_w3[i] = gd[i] * cos_t;
    }
    // the basis: b = wx wy a, a = -1 / (sign + wz), da / dwz = a^2
    const float g_b = g_u[1] * sign + g_v[0];
    const float g_a =
        g_u[0] * sign * w[0] * w[0] + g_v[1] * w[1] * w[1] + g_b * w[0] * w[1];
    g_w3[0] += g_u[0] * sign * 2.0f * w[0] * a + g_b * w[1] * a - g_u[2] * sign;
    g_w3[1] += g_v[1] * 2.0f * w[1] * a + g_b * w[0] * a - g_v[2];
    g_w3[2] += g_a * a * a;
    // sin_t = sqrt_pos(1 - cos_t^2), cos_t = 1 - u1 (1 - cos_max)
    if (st_arg > 1e-12f) g_cos -= 2.0f * cos_t * (g_sin * 0.5f / sin_t);
    g_cm += u1 * g_cos;
    // cos_max = sqrt_pos(1 - r2 / dd), dd = at_least(d2, 1e-12)
    float g_dd = 0.0f;
    if (cm_arg > 0.0f) {
      const float g_arg = g_cm * 0.5f / cos_max;
      g_r2 -= g_arg / dd;
      g_dd = g_arg * r2 / (dd * dd);
    }
    if (d2 >= 1e-12f) g_d2 += g_dd;
    g_d2 += unit_adjoint(to, d2, g_w3, g_to);
    d2_adjoint(to, g_d2, g_to);
    // to = c - p, c = c0 + tm dc, r2 = r^2
    for (int i = 0; i < 3; ++i) {
      gp[i] -= g_to[i];
      gq[1 + i] += g_to[i];
      gq[4 + i] += tm * g_to[i];
      *g_tm += g_to[i] * q[4 + i];
    }
    gq[7] += 2.0f * q[7] * g_r2;
  } else {  // triangle: a uniform point on it
    const float e1[3] = {q[4], q[5], q[6]}, e2[3] = {q[7], q[8], q[9]};
    const float area = q[10];
    const float su = sqrtf(at_least(u1, 1e-12f));
    const float bu = 1.0f - su;
    const float bv = u2 * su;
    float to[3];
    for (int i = 0; i < 3; ++i)
      to[i] = q[1 + i] + bu * e1[i] + bv * e2[i] - p[i];
    const float d2 = dot3(to, to);
    const float dd = at_least(d2, 1e-12f);
    const float dist = sqrtf(dd);
    const float inv_d = 1.0f / dist;
    const float dir[3] = {to[0] * inv_d, to[1] * inv_d, to[2] * inv_d};
    // t = at_least(dist, 1e-4), dist = sqrt(dd)
    if (dist >= 1e-4f && d2 >= 1e-12f) g_d2 += g_t * 0.5f / dist;
    const float nb[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                         e1[2] * e2[0] - e1[0] * e2[2],
                         e1[0] * e2[1] - e1[1] * e2[0]};
    const float l2 = dot3(nb, nb);
    const float nlen = sqrtf(at_least(l2, 1e-24f));
    const float dn = dot3(dir, nb);
    const float cos_a = -dn / nlen;
    const bool ok = cos_a > 1e-6f;
    const float nn = cos_a * area * n;
    // geo = nn / (pi dd), pdf = d2 / at_least(nn, 1e-12)
    const float geo = ok ? nn / (kPi * dd) : 0.0f;
    float g_geo = 0.0f;
    for (int c = 0; c < 3; ++c) {
      gq[11 + c] += g_w[c] * geo;
      g_geo += g_w[c] * q[11 + c];
    }
    float g_nn = 0.0f, g_dd = 0.0f;
    if (ok) {
      const float den = kPi * dd;
      g_nn += g_geo / den;
      g_dd -= g_geo * nn / (den * den) * kPi;
      const float m = at_least(nn, 1e-12f);
      g_d2 += g_pdf / m;
      if (nn >= 1e-12f) g_nn -= g_pdf * d2 / (m * m);
    }
    const float g_cos_a = g_nn * area * n;
    gq[10] += g_nn * cos_a * n;
    // cos_a = -(dir . nb) / nlen, nlen = sqrt(at_least(|nb|^2, 1e-24))
    float g_dir[3], g_nb[3];
    const float g_nlen = g_cos_a * dn / (nlen * nlen);
    for (int i = 0; i < 3; ++i) {
      g_dir[i] = gd[i] - g_cos_a * nb[i] / nlen;
      g_nb[i] = -g_cos_a * dir[i] / nlen;
      if (l2 >= 1e-24f) g_nb[i] += nb[i] * (g_nlen / nlen);
    }
    float g_e1[3] = {0.0f, 0.0f, 0.0f}, g_e2[3] = {0.0f, 0.0f, 0.0f};
    cross_adjoint(e1, e2, g_nb, g_e1, g_e2);
    if (d2 >= 1e-12f) g_d2 += g_dd;
    g_d2 += unit_adjoint(to, d2, g_dir, g_to);
    d2_adjoint(to, g_d2, g_to);
    // to = v0 + bu e1 + bv e2 - p
    for (int i = 0; i < 3; ++i) {
      gp[i] -= g_to[i];
      gq[1 + i] += g_to[i];
      gq[4 + i] += g_e1[i] + bu * g_to[i];
      gq[7 + i] += g_e2[i] + bv * g_to[i];
    }
  }
}

// The adjoint of light_pdf_toward(L, r, t_hit): from the pdf's cotangent
// g_pdf to the ray's origin g_o, direction g_d and time *g_tm (all added)
// and the matching lights' rows (g_lrows, (n_lights, 14)).  t_hit enters
// only the matching test, which is discrete.
template <Sweep kSweep = Sweep::kThread>
RTOW_HD void light_pdf_adjoint(const Lit& L, const Ray& r, float t_hit,
                               float g_pdf, float* g_o, float* g_d,
                               float* g_tm, const RowSums& g_lrows) {
  const float n = static_cast<float>(L.n_lights);
  const float d[3] = {r.dx, r.dy, r.dz};
  const float o[3] = {r.ox, r.oy, r.oz};
  const float a2 = dot3(d, d);
  const float dlen = sqrtf(at_least(a2, 1e-24f));
  const float inv_l = 1.0f / dlen;
  const float u[3] = {d[0] * inv_l, d[1] * inv_l, d[2] * inv_l};
  const float th = t_hit * dlen;
  float g_u[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < L.n_lights; ++k) {
    const float* q = L.rows + kLitCols * k;
    float gq[kLitCols] = {};
    if (((L.light_kinds >> (2 * k)) & 3u) == 0u) {
      const float c[3] = {q[1] + r.tm * q[4], q[2] + r.tm * q[5],
                          q[3] + r.tm * q[6]};
      const float r2 = q[7] * q[7];
      const float to[3] = {c[0] - o[0], c[1] - o[1], c[2] - o[2]};
      const float d2 = dot3(to, to);
      const float oc_d = -dot3(to, u);
      const float disc = oc_d * oc_d - (d2 - r2);
      const float t_k = -oc_d - sqrt_pos(disc, 0.0f);
      const bool ok = d2 > r2 && disc > 0.0f && t_k > 0.0f;
      if (!(ok && fabsf(t_k - th) <= 1e-3f * at_least(th, 1.0f))) continue;
      const float dd = at_least(d2, 1e-12f);
      const float cm_arg = 1.0f - r2 / dd;
      const float cos_max = sqrt_pos(cm_arg, 0.0f);
      const float x = kTwoPi * (1.0f - cos_max) * n;  // pdf_k = 1 / x
      const float g_cm = x >= 1e-12f ? kTwoPi * n * g_pdf / (x * x) : 0.0f;
      float g_r2 = 0.0f, g_d2 = 0.0f;
      if (cm_arg > 0.0f) {
        const float g_arg = g_cm * 0.5f / cos_max;
        g_r2 = -g_arg / dd;
        if (d2 >= 1e-12f) g_d2 = g_arg * r2 / (dd * dd);
      }
      float g_to[3] = {0.0f, 0.0f, 0.0f};
      d2_adjoint(to, g_d2, g_to);
      for (int i = 0; i < 3; ++i) {
        g_o[i] -= g_to[i];
        gq[1 + i] += g_to[i];
        gq[4 + i] += r.tm * g_to[i];
        *g_tm += g_to[i] * q[4 + i];
      }
      gq[7] += 2.0f * q[7] * g_r2;
    } else {  // Moller-Trumbore, front side only
      const float v0[3] = {q[1], q[2], q[3]};
      const float e1[3] = {q[4], q[5], q[6]}, e2[3] = {q[7], q[8], q[9]};
      const float pv[3] = {u[1] * e2[2] - u[2] * e2[1],
                           u[2] * e2[0] - u[0] * e2[2],
                           u[0] * e2[1] - u[1] * e2[0]};
      const float det = dot3(e1, pv);
      const bool det_ok = !(fabsf(det) < 1e-12f);
      const float inv = 1.0f / (det_ok ? det : 1.0f);
      const float sv[3] = {o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]};
      const float bu = dot3(sv, pv) * inv;
      const float qv[3] = {sv[1] * e1[2] - sv[2] * e1[1],
                           sv[2] * e1[0] - sv[0] * e1[2],
                           sv[0] * e1[1] - sv[1] * e1[0]};
      const float bv = dot3(u, qv) * inv;
      const float e2q = dot3(e2, qv);
      const float t_k = e2q * inv;
      const bool ok = det >= 1e-6f && bu >= 0.0f && bv >= 0.0f &&
                      bu + bv <= 1.0f && t_k > 0.0f;
      if (!(ok && fabsf(t_k - th) <= 1e-3f * at_least(th, 1.0f))) continue;
      const float nb[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                           e1[2] * e2[0] - e1[0] * e2[2],
                           e1[0] * e2[1] - e1[1] * e2[0]};
      const float l2 = dot3(nb, nb);
      const float nlen = sqrtf(at_least(l2, 1e-24f));
      const float un = dot3(u, nb);
      const float cos_a = -un / nlen;
      const float nn = cos_a * q[10] * n;
      const float m = at_least(nn, 1e-12f);  // pdf_k = t_k^2 / m
      const float g_tk = g_pdf * 2.0f * t_k / m;
      const float g_nn = nn >= 1e-12f ? -g_pdf * t_k * t_k / (m * m) : 0.0f;
      const float g_cos_a = g_nn * q[10] * n;
      gq[10] += g_nn * cos_a * n;
      const float g_nlen = g_cos_a * un / (nlen * nlen);
      float g_nb[3], g_e1[3] = {0.0f, 0.0f, 0.0f}, g_e2[3] = {0.0f, 0.0f, 0.0f};
      for (int i = 0; i < 3; ++i) {
        g_u[i] -= g_cos_a * nb[i] / nlen;
        g_nb[i] = -g_cos_a * u[i] / nlen;
        if (l2 >= 1e-24f) g_nb[i] += nb[i] * (g_nlen / nlen);
      }
      cross_adjoint(e1, e2, g_nb, g_e1, g_e2);
      // t_k = (e2 . qv) inv, inv = 1 / det where |det| >= 1e-12
      float g_qv[3], g_pv[3], g_sv[3] = {0.0f, 0.0f, 0.0f};
      for (int i = 0; i < 3; ++i) {
        g_e2[i] += qv[i] * (g_tk * inv);
        g_qv[i] = e2[i] * (g_tk * inv);
      }
      const float g_det = det_ok ? -(g_tk * e2q) * inv * inv : 0.0f;
      for (int i = 0; i < 3; ++i) {
        g_e1[i] += pv[i] * g_det;
        g_pv[i] = e1[i] * g_det;
      }
      cross_adjoint(u, e2, g_pv, g_u, g_e2);   // pv = u x e2
      cross_adjoint(sv, e1, g_qv, g_sv, g_e1);  // qv = sv x e1
      for (int i = 0; i < 3; ++i) {
        g_o[i] += g_sv[i];
        gq[1 + i] -= g_sv[i];
        gq[4 + i] += g_e1[i];
        gq[7 + i] += g_e2[i];
      }
    }
    add_rows<kSweep>(g_lrows, k, gq);
  }
  // u = d / sqrt(at_least(|d|^2, 1e-24))
  const float g_inv = dot3(g_u, d);
  const float g_dlen = -g_inv * inv_l * inv_l;
  const float g_a2 = a2 >= 1e-24f ? g_dlen * 0.5f / dlen : 0.0f;
  for (int i = 0; i < 3; ++i) g_d[i] += g_u[i] * inv_l + 2.0f * d[i] * g_a2;
}

// The value and gradient (gx, gy, gz) of value_noise at a point: the
// trilinear blend of the lattice hashes with the smoothstep fade u(f) =
// f^2 (3 - 2f), du/df = 6 f (1 - f); floor is flat.
RTOW_HD float value_noise_grad(float px, float py, float pz, float* g) {
  const float ix = floorf(px), iy = floorf(py), iz = floorf(pz);
  const float fx = px - ix, fy = py - iy, fz = pz - iz;
  const float ux = fx * fx * (3.0f - 2.0f * fx);
  const float uy = fy * fy * (3.0f - 2.0f * fy);
  const float uz = fz * fz * (3.0f - 2.0f * fz);
  const int xi = static_cast<int>(ix), yi = static_cast<int>(iy);
  const int zi = static_cast<int>(iz);
  float h[2][2][2];
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 2; ++b)
      for (int c = 0; c < 2; ++c) h[a][b][c] = hash01(xi + a, yi + b, zi + c);
  const float c00 = lerp(h[0][0][0], h[1][0][0], ux);
  const float c10 = lerp(h[0][1][0], h[1][1][0], ux);
  const float c01 = lerp(h[0][0][1], h[1][0][1], ux);
  const float c11 = lerp(h[0][1][1], h[1][1][1], ux);
  const float y0 = lerp(c00, c10, uy), y1 = lerp(c01, c11, uy);
  const float dvx =
      (1.0f - uz) * ((1.0f - uy) * (h[1][0][0] - h[0][0][0]) +
                     uy * (h[1][1][0] - h[0][1][0])) +
      uz * ((1.0f - uy) * (h[1][0][1] - h[0][0][1]) +
            uy * (h[1][1][1] - h[0][1][1]));
  const float dvy = (1.0f - uz) * (c10 - c00) + uz * (c11 - c01);
  const float dvz = y1 - y0;
  g[0] = dvx * 6.0f * fx * (1.0f - fx);
  g[1] = dvy * 6.0f * fy * (1.0f - fy);
  g[2] = dvz * 6.0f * fz * (1.0f - fz);
  return lerp(y0, y1, uz);
}

// The adjoint of marble_t(p, scale): g_t to the point's gp and the scale's
// *g_s (both added).  Octave j reads the point p * scale * 2^j (plus its
// offset), so its gradient reaches p times scale 2^j and scale through
// p 2^j.
RTOW_HD void marble_t_adjoint(const float* p, float scale, float g_t,
                              float* gp, float* g_s) {
  float g1[3], g2[3], g3[3];
  const float v1 = value_noise_grad(p[0] * scale, p[1] * scale, p[2] * scale,
                                    g1);
  const float v2 = value_noise_grad(p[0] * scale * 2.0f + 17.0f,
                                    p[1] * scale * 2.0f, p[2] * scale * 2.0f,
                                    g2);
  const float v3 = value_noise_grad(p[0] * scale * 4.0f,
                                    p[1] * scale * 4.0f + 31.0f,
                                    p[2] * scale * 4.0f, g3);
  const float turb = (v1 + 0.5f * v2 + 0.25f * v3) / 1.75f;
  const float g_arg = g_t * 0.5f * cosf(scale * p[2] + 10.0f * turb);
  *g_s += g_arg * p[2];
  gp[2] += g_arg * scale;
  const float g_sum = g_arg * 10.0f / 1.75f;
  for (int i = 0; i < 3; ++i) {
    const float g_i = g_sum * (g1[i] + g2[i] + g3[i]);  // 1, 0.5 x 2, 0.25 x 4
    gp[i] += g_i * scale;
    *g_s += g_i * p[i];
  }
}

// The adjoint of textured() for winner sphere k at hit point e: from the
// textured albedo's cotangent (g.al*) to the row's albedo (left in g.al*),
// its second colour (gw[13..15]), and for noise its scale (g.ir) and the
// hit point (g.p*).  m0 is the untextured material.  The checker's cell is
// a select: its albedo's cotangent goes to columns 7-9 or 13-15, none to
// the point.
RTOW_HD void texture_adjoint(const float4* tbl, int k, const Material& m0,
                             const Hit& e, ShadeGrad* g, float* gw) {
  const float4 q3 = tbl[4 * k + 3];
  if (m0.kind == kChecker) {
    const float sp =
        sinf(m0.ir * e.px) * sinf(m0.ir * e.py) * sinf(m0.ir * e.pz);
    if (sp < 0.0f) {
      gw[13] = g->alr;
      gw[14] = g->alg;
      gw[15] = g->alb;
      g->alr = g->alg = g->alb = 0.0f;
    }
  } else if (m0.kind == kNoise) {  // al + (al2 - al) t, t = marble_t(p, ir)
    const float p[3] = {e.px, e.py, e.pz};
    const float t = marble_t(e.px, e.py, e.pz, m0.ir);
    const float g_t = g->alr * (q3.y - m0.alr) + g->alg * (q3.z - m0.alg) +
                      g->alb * (q3.w - m0.alb);
    gw[13] = g->alr * t;
    gw[14] = g->alg * t;
    gw[15] = g->alb * t;
    g->alr -= g->alr * t;
    g->alg -= g->alg * t;
    g->alb -= g->alb * t;
    float gp[3] = {g->px, g->py, g->pz};
    marble_t_adjoint(p, m0.ir, g_t, gp, &g->ir);
    g->px = gp[0];
    g->py = gp[1];
    g->pz = gp[2];
  }
}

// ---- the media's adjoints ---------------------------------------------------

// z = max(x, y) and z = min(x, y): z's cotangent g to x's and y's (added),
// half to each at a tie, as torch.maximum and torch.minimum pass it.
RTOW_HD void max_adjoint(float x, float y, float g, float* gx, float* gy) {
  if (x > y) {
    *gx += g;
  } else if (x < y) {
    *gy += g;
  } else {
    *gx += 0.5f * g;
    *gy += 0.5f * g;
  }
}

RTOW_HD void min_adjoint(float x, float y, float g, float* gx, float* gy) {
  max_adjoint(-x, -y, g, gx, gy);
}

// The adjoint of vol_interval for volume k along a ray (o, d) that crosses
// its boundary: from the cotangents g_t0, g_t1 of the interval to the ray's
// g_o, g_d and the volume row's gq (14), all added.  A sphere: both roots
// of the quadratic (columns 0-3).  A box: the slabs' min / max (columns
// 0-5); a rotated box also through the ray's inverse rotation and
// translation (columns 7 and 11-13).  A direction component inside the
// 1e-24 guard is the constant there.
RTOW_HD void vol_interval_adjoint(const Lit& L, int k, const float* o,
                                  const float* d, float g_t0, float g_t1,
                                  float* g_o, float* g_d, float* gq) {
  const float* q = L.rows + kLitCols * (L.vol_row0 + k);
  const uint32_t kind = (L.vol_kinds >> (2 * k)) & 3u;
  if (kind == 0u) {  // t0, t1 = (-h -/+ sq) inv_a, sq = sqrt(disc)
    const float oc[3] = {o[0] - q[0], o[1] - q[1], o[2] - q[2]};
    const float a = dot3(d, d);
    const float h = dot3(oc, d);
    const float c = dot3(oc, oc) - q[3] * q[3];
    const float disc = h * h - a * c;
    const float sq = sqrtf(disc);
    const float inv_a = 1.0f / at_least(a, 1e-24f);
    const float g_inv = g_t0 * (-h - sq) + g_t1 * (-h + sq);
    float g_h = -(g_t0 + g_t1) * inv_a;
    const float g_disc = (g_t1 - g_t0) * inv_a * 0.5f / sq;
    // disc = h^2 - a c
    g_h += 2.0f * h * g_disc;
    float g_a = -c * g_disc;
    const float g_c = -a * g_disc;
    if (a >= 1e-24f) g_a -= g_inv * inv_a * inv_a;
    // c = |oc|^2 - r^2, h = oc . d, a = |d|^2, oc = o - center
    for (int i = 0; i < 3; ++i) {
      const float g_oc = 2.0f * oc[i] * g_c + g_h * d[i];
      g_o[i] += g_oc;
      gq[i] -= g_oc;
      g_d[i] += g_h * oc[i] + 2.0f * d[i] * g_a;
    }
    gq[3] -= 2.0f * q[3] * g_c;
    return;
  }
  float lo_o[3] = {o[0], o[1], o[2]}, lo_d[3] = {d[0], d[1], d[2]};
  float cs = 1.0f, sn = 0.0f, w[3] = {0.0f, 0.0f, 0.0f};
  if (kind == 2u) {  // the ray in the box's frame
    vol_frame(L, k, q, &cs, &sn);
    for (int i = 0; i < 3; ++i) w[i] = o[i] - q[11 + i];
    lo_o[0] = cs * w[0] - sn * w[2];
    lo_o[1] = w[1];
    lo_o[2] = sn * w[0] + cs * w[2];
    lo_d[0] = cs * d[0] - sn * d[2];
    lo_d[2] = sn * d[0] + cs * d[2];
  }
  float inv[3], ta[3], tb[3], lo[3], hi[3];
  for (int i = 0; i < 3; ++i) {
    const float di = fabsf(lo_d[i]) < 1e-24f
                         ? (lo_d[i] < 0.0f ? -1e-24f : 1e-24f)
                         : lo_d[i];
    inv[i] = 1.0f / di;
    ta[i] = (q[i] - lo_o[i]) * inv[i];
    tb[i] = (q[3 + i] - lo_o[i]) * inv[i];
    lo[i] = ta[i] < tb[i] ? ta[i] : tb[i];
    hi[i] = ta[i] > tb[i] ? ta[i] : tb[i];
  }
  // t0 = max(max(lo0, lo1), lo2), t1 = min(min(hi0, hi1), hi2)
  float g_lo[3] = {0.0f, 0.0f, 0.0f}, g_hi[3] = {0.0f, 0.0f, 0.0f};
  float g_m = 0.0f, g_n = 0.0f;
  max_adjoint(lo[0] > lo[1] ? lo[0] : lo[1], lo[2], g_t0, &g_m, &g_lo[2]);
  max_adjoint(lo[0], lo[1], g_m, &g_lo[0], &g_lo[1]);
  min_adjoint(hi[0] < hi[1] ? hi[0] : hi[1], hi[2], g_t1, &g_n, &g_hi[2]);
  min_adjoint(hi[0], hi[1], g_n, &g_hi[0], &g_hi[1]);
  float g_lo_o[3], g_lo_d[3];
  for (int i = 0; i < 3; ++i) {
    // lo = min(ta, tb), hi = max(ta, tb); ta = (lo_col - o) inv, tb alike
    float g_ta = 0.0f, g_tb = 0.0f;
    min_adjoint(ta[i], tb[i], g_lo[i], &g_ta, &g_tb);
    max_adjoint(ta[i], tb[i], g_hi[i], &g_ta, &g_tb);
    gq[i] += g_ta * inv[i];
    gq[3 + i] += g_tb * inv[i];
    g_lo_o[i] = -(g_ta * inv[i] + g_tb * inv[i]);
    const float g_inv = g_ta * (q[i] - lo_o[i]) + g_tb * (q[3 + i] - lo_o[i]);
    g_lo_d[i] = fabsf(lo_d[i]) < 1e-24f ? 0.0f : -g_inv * inv[i] * inv[i];
  }
  if (kind == 2u) {
    // lo_o = R w, lo_d = R d: R = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    const float g_c = g_lo_o[0] * w[0] + g_lo_o[2] * w[2] +
                      g_lo_d[0] * d[0] + g_lo_d[2] * d[2];
    const float g_s = -g_lo_o[0] * w[2] + g_lo_o[2] * w[0] -
                      g_lo_d[0] * d[2] + g_lo_d[2] * d[0];
    gq[7] += cs * g_s - sn * g_c;
    const float g_w[3] = {cs * g_lo_o[0] + sn * g_lo_o[2], g_lo_o[1],
                          -sn * g_lo_o[0] + cs * g_lo_o[2]};
    for (int i = 0; i < 3; ++i) {
      g_o[i] += g_w[i];
      gq[11 + i] -= g_w[i];
    }
    g_d[0] += cs * g_lo_d[0] + sn * g_lo_d[2];
    g_d[1] += g_lo_d[1];
    g_d[2] += -sn * g_lo_d[0] + cs * g_lo_d[2];
  } else {
    for (int i = 0; i < 3; ++i) {
      g_o[i] += g_lo_o[i];
      g_d[i] += g_lo_d[i];
    }
  }
}

// |d| = sqrt(at_least(|d|^2, 1e-24)): adds its cotangent g_len to d's.
RTOW_HD void len_adjoint(const float* d, float g_len, float* g_d) {
  const float a2 = dot3(d, d);
  if (!(a2 >= 1e-24f)) return;
  const float g_a2 = g_len * 0.5f / sqrtf(a2);
  for (int i = 0; i < 3; ++i) g_d[i] += 2.0f * d[i] * g_a2;
}

// The adjoint of transmittance(L, r, t_max) = T = exp(-tau),
// tau = sum_k sigma_k at_least(min(t1, t_max) - at_least(t0, 0), 0) |d|
// over the volumes the ray crosses: from T's cotangent g_T to the ray's
// origin g_o and direction g_d, t_max's *g_tmax (all added) and the volume
// rows' g_lrows (from row vol_row0 on).
template <Sweep kSweep = Sweep::kThread>
RTOW_HD void transmittance_adjoint(const Lit& L, const Ray& r, float t_max,
                                   float T, float g_T, float* g_o,
                                   float* g_d, float* g_tmax,
                                   const RowSums& g_lrows) {
  const float o[3] = {r.ox, r.oy, r.oz}, d[3] = {r.dx, r.dy, r.dz};
  const float dlen = sqrtf(at_least(dot3(d, d), 1e-24f));
  const float g_tau = -g_T * T;
  float g_len = 0.0f;
  for (int k = 0; k < L.n_vol; ++k) {
    float t0, t1;
    if (!vol_interval(L, k, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, &t0, &t1))
      continue;
    const float* q = L.rows + kLitCols * (L.vol_row0 + k);
    const float t_out = t1 < t_max ? t1 : t_max;
    const float raw = t_out - at_least(t0, 0.0f);
    const float overlap = at_least(raw, 0.0f);
    // tau += (sigma overlap) |d|
    float gq[kLitCols] = {};
    const float g_so = g_tau * dlen;
    g_len += g_tau * (q[6] * overlap);
    gq[6] = g_so * overlap;
    const float g_ov = raw >= 0.0f ? g_so * q[6] : 0.0f;
    float g_t1 = 0.0f;
    min_adjoint(t1, t_max, g_ov, &g_t1, g_tmax);
    vol_interval_adjoint(L, k, o, d, t0 >= 0.0f ? -g_ov : 0.0f, g_t1, g_o,
                         g_d, gq);
    add_rows<kSweep>(g_lrows, L.vol_row0 + k, gq);
  }
  len_adjoint(d, g_len, g_d);
}

// The adjoint of volume k's free-flight distance along r,
// t_v = at_least(t0, 1e-3) + (-log u) / max(sigma, 1e-12) / |d| with u the
// lane's uniform at salt 16 + k: from t_v's cotangent g_tv to the ray's
// g_o, g_d and the volume row's gq (all added).
RTOW_HD void free_flight_adjoint(const Lit& L, int k, const Ray& r,
                                 uint32_t lane, uint32_t salt, float g_tv,
                                 float* g_o, float* g_d, float* gq) {
  const float o[3] = {r.ox, r.oy, r.oz}, d[3] = {r.dx, r.dy, r.dz};
  const float* q = L.rows + kLitCols * (L.vol_row0 + k);
  float t0, t1;
  vol_interval(L, k, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, &t0, &t1);
  const float dlen = sqrtf(at_least(dot3(d, d), 1e-24f));
  const float sigma = q[6] < 1e-12f ? 1e-12f : q[6];
  const float x = -logf(at_least(uniform(lane, salt, 16 + k), 1e-12f)) / sigma;
  // step = x / |d|, x = -log u / sigma
  const float g_x = g_tv / dlen;
  len_adjoint(d, -g_tv * (x / dlen) / dlen, g_d);
  if (q[6] >= 1e-12f) gq[6] -= g_x * (x / sigma);
  vol_interval_adjoint(L, k, o, d, t0 >= 1e-3f ? g_tv : 0.0f, 0.0f, g_o, g_d,
                       gq);
}

// The adjoint of next_event from p = (px, py, pz): a surface hit's with
// the normal n and the textured albedo, or a volume event's (`volume`: the
// isotropic phase, n unused) with the medium's albedo.  Replays the light
// sample and the shadow sweep (counting it in tally as the forward does);
// where the shadow ray got through, maps the radiance cotangents G[10..12]
// to the throughput's gin[7..9], the point's, the normal's and the
// albedo's (g), the time's (*g_tm), the picked light's row and, through
// the shadow ray's transmittance, the volume rows (g_lrows), all added.
// kSweep: how the shadow ray sweeps the triangles, as in next_event.
template <bool kTris, Sweep kSweep = Sweep::kThread>
RTOW_HD void next_event_adjoint(const float4* tbl, int npad, const Tris& tris,
                                const Lit& L, const float* s, float px,
                                float py, float pz, float nx, float ny,
                                float nz, float nar, float nag, float nab,
                                bool volume, uint32_t lane, uint32_t salt,
                                const float* G, float* gin, ShadeGrad* g,
                                float* g_tm, const RowSums& g_lrows,
                                Tally* tally) {
  const float pick = uniform(lane, salt, 8);
  const float u1 = uniform(lane, salt, 9);
  const float u2 = uniform(lane, salt, 10);
  int k = static_cast<int>(pick * static_cast<float>(L.n_lights));
  if (k > L.n_lights - 1) k = L.n_lights - 1;
  const LightSample ls = sample_light(L, k, u1, u2, px, py, pz, s[6]);
  const float thresh = ls.t * kShadowFrac;
  const float dot = nx * ls.dx + ny * ls.dy + nz * ls.dz;
  const float cos_t = at_least(dot, 0.0f);
  const float phase = volume ? kQuarterInvPi : cos_t * kInvPi;
  const float f0 = volume ? 0.25f : cos_t;
  const float sum = ls.pdf + phase;
  const float den = at_least(sum, kEps12);
  const float w_l = ls.pdf / den;
  const Ray sr{px, py, pz, ls.dx, ls.dy, ls.dz, s[6]};
  const float la = sr.dx * sr.dx + sr.dy * sr.dy + sr.dz * sr.dz;
  ++tally->shadows;
  float st;
  int sk;
  nearest_sphere(tbl, npad, sr, la, 1.0f / la, thresh, &st, &sk);
  if constexpr (kTris)
    nearest_triangle_by<kSweep>(tris, sr, npad, &st, &sk, tally);
  if (!(st >= thresh)) return;  // blocked: nothing was added
  const float T = L.n_vol > 0 ? transmittance(L, sr, ls.t) : 1.0f;
  const float factor = f0 * T;
  const float cw = factor * w_l;

  // c_c = tp_c al_c w_c cw
  const float al[3] = {nar, nag, nab};
  const float lw[3] = {ls.w0, ls.w1, ls.w2};
  float g_w[3], g_al[3], g_cw = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float gc = G[10 + c];
    gin[7 + c] += gc * al[c] * lw[c] * cw;
    g_al[c] = gc * s[7 + c] * lw[c] * cw;
    g_w[c] = gc * s[7 + c] * al[c] * cw;
    g_cw += gc * s[7 + c] * al[c] * lw[c];
  }
  g->alr += g_al[0];
  g->alg += g_al[1];
  g->alb += g_al[2];
  // cw = (f0 T) w_l, w_l = pdf / at_least(pdf + phase, 1e-12); at a
  // surface f0 = cos_t and phase = cos_t / pi, at a volume event constants
  const float g_wl = g_cw * factor;
  const float g_factor = g_cw * w_l;
  float g_pdf = g_wl / den, g_cos = volume ? 0.0f : g_factor * T;
  if (sum >= kEps12) {
    const float g_den = -g_wl * ls.pdf / (den * den);
    g_pdf += g_den;
    if (!volume) g_cos += g_den * kInvPi;
  }
  float gp[3] = {0.0f, 0.0f, 0.0f}, g_dir[3] = {0.0f, 0.0f, 0.0f};
  float g_t = 0.0f;
  if (L.n_vol > 0)
    transmittance_adjoint<kSweep>(L, sr, ls.t, T, g_factor * f0, gp, g_dir,
                                  &g_t, g_lrows);
  const float g_dot = dot >= 0.0f ? g_cos : 0.0f;
  g->nx += g_dot * ls.dx;
  g->ny += g_dot * ls.dy;
  g->nz += g_dot * ls.dz;
  g_dir[0] += g_dot * nx;
  g_dir[1] += g_dot * ny;
  g_dir[2] += g_dot * nz;
  const float p[3] = {px, py, pz};
  float gq[kLitCols] = {};
  sample_light_adjoint(L, k, u1, u2, p, s[6], g_dir, g_pdf, g_w, g_t, gp,
                       g_tm, gq);
  g->px += gp[0];
  g->py += gp[1];
  g->pz += gp[2];
  add_rows<kSweep>(g_lrows, k, gq);
}

// The adjoint of an emissive hit's radiance, rad' = rad + tp al w_emit
// (bounce.cuh, the emission branch of bounce_lane_t): gin[7..9] and the
// winner's albedo cotangent g_al (3) from G[10..12]; under NEE after a
// diffuse scatter, w_emit = p_b / at_least(p_b + p_l, 1e-12), with
// p_b = |d| / (2 pi) and p_l = light_pdf_toward(L, r, t_hit), adds to the
// direction's gin[3..5], the origin's gin[0..2], the time's *g_tm and the
// light rows' g_lrows.
template <Sweep kSweep = Sweep::kThread>
RTOW_HD void emission_adjoint(const Lit& L, const Ray& r, float a,
                              float t_hit, const Material& m, bool mis,
                              const float* s, const float* G, float* gin,
                              float* g_al, float* g_tm,
                              const RowSums& g_lrows) {
  float w_emit = 1.0f, p_b = 0.0f, sum = 0.0f, den = 1.0f;
  if (mis) {
    const float p_l = light_pdf_toward(L, r, t_hit);
    p_b = sqrtf(a) * kHalfInvPi;
    sum = p_b + p_l;
    den = at_least(sum, kEps12);
    w_emit = p_b / den;
  }
  const float al[3] = {m.alr, m.alg, m.alb};
  float g_w = 0.0f;
  for (int c = 0; c < 3; ++c) {
    gin[7 + c] += G[10 + c] * al[c] * w_emit;
    g_al[c] = G[10 + c] * s[7 + c] * w_emit;
    g_w += G[10 + c] * s[7 + c] * al[c];
  }
  if (!mis) return;
  float g_pb = g_w / den, g_pl = 0.0f;
  if (sum >= kEps12) {
    const float g_den = -g_w * p_b / (den * den);
    g_pb += g_den;
    g_pl = g_den;
  }
  const float g_a = g_pb * kHalfInvPi * 0.5f / sqrtf(a);  // p_b = sqrt(a) c
  gin[3] += 2.0f * r.dx * g_a;
  gin[4] += 2.0f * r.dy * g_a;
  gin[5] += 2.0f * r.dz * g_a;
  light_pdf_adjoint<kSweep>(L, r, t_hit, g_pl, gin, gin + 3, g_tm, g_lrows);
}

// The adjoint of a volume scatter (the volume branch of bounce_lane_t)
// at t_v in volume kv with the medium's albedo v_alb: the new state is
// o' = p = o + t_v d, the isotropic direction (a constant), tp' = tp alb,
// and under NEE rad' = rad + the light sample's contribution from p.  Writes
// gin[0..5] and gin[7..9], adds to gin[6] (a moving light's time) and the
// rows' g_lrows: the volume's density, albedo and boundary, the picked
// light's, and every volume's the shadow ray crosses.
template <bool kTris, Sweep kSweep = Sweep::kThread>
RTOW_HD void volume_adjoint(const float4* tbl, int npad, const Tris& tris,
                            const Lit& L, const float* s, const Ray& r,
                            int kv, float v_t, const float* v_alb, bool nee,
                            uint32_t lane, uint32_t salt, const float* G,
                            float* gin, const RowSums& g_lrows, Tally* tally) {
  const float d[3] = {r.dx, r.dy, r.dz};
  const float p[3] = {r.ox + v_t * r.dx, r.oy + v_t * r.dy,
                      r.oz + v_t * r.dz};
  float gq[kLitCols] = {};
  ShadeGrad g{};
  g.px = G[0];
  g.py = G[1];
  g.pz = G[2];
  for (int c = 0; c < 3; ++c) {
    gin[7 + c] = G[7 + c] * v_alb[c];
    gq[8 + c] = G[7 + c] * s[7 + c];
  }
  float g_tm = 0.0f;
  if (nee)
    next_event_adjoint<kTris, kSweep>(tbl, npad, tris, L, s, p[0], p[1], p[2],
                                      0.0f, 0.0f, 0.0f, v_alb[0], v_alb[1],
                                      v_alb[2], true, lane, salt, G, gin, &g,
                                      &g_tm, g_lrows, tally);
  gq[8] += g.alr;
  gq[9] += g.alg;
  gq[10] += g.alb;
  // p = o + t_v d
  const float gp[3] = {g.px, g.py, g.pz};
  float g_o[3] = {gp[0], gp[1], gp[2]};
  float g_d[3] = {gp[0] * v_t, gp[1] * v_t, gp[2] * v_t};
  free_flight_adjoint(L, kv, r, lane, salt, dot3(gp, d), g_o, g_d, gq);
  for (int i = 0; i < 3; ++i) {
    gin[i] = g_o[i];
    gin[3 + i] = g_d[i];
  }
  gin[6] += g_tm;
  add_rows<kSweep>(g_lrows, L.vol_row0 + kv, gq);
}

// Replays bounce_lane_t<kTris, kLit> for a live lane from its saved input
// state s (13 floats, bounce) and maps the output cotangents G (13, in the
// order of s) to the input cotangents gin (13) and the winner row's
// cotangents gw (kParamGrads for a sphere, or kTexParamGrads with
// textures; kTriParamGrads for a triangle; in its table's column order;
// the caller zeroes it).  Returns the winner's id (spheres 0 .. npad - 1,
// triangles npad + row), or -1 where the bounce read no row (a miss, a
// non-emissive hit at depth, a volume event).  kTris sweeps `tris` after
// the spheres, counting its work in `tally`, as the forward does.  kLit
// replays the lit bounce with the features L has (the free-flight event
// before the surface, emission, NEE toward L.n_lights lights with the
// shadow ray's transmittance, the textures; from_diffuse is the input alive
// code 2) and adds the rows' cotangent to g_lrows (the light rows, then the
// volume rows from L.vol_row0: all of L's rows x 14).  kSweep: the
// triangle sweeps one thread alone, or the 32 threads of a warp on the same
// lane (K5's warp form: every thread runs the adjoint on the same inputs
// and ends with the same cotangents; only lane 0 adds to g_lrows).
template <bool kTris, bool kLit = false, Sweep kSweep = Sweep::kThread>
RTOW_HD int bounce_lane_adjoint_t(const float4* tbl, int npad,
                                  const Tris& tris, const float* s,
                                  int bounce, uint32_t lane, uint32_t salt,
                                  int max_depth, const Background& bg,
                                  const float* G, float* gin, float* gw,
                                  Tally* tally, const Lit& L = Lit{},
                                  bool from_diffuse = false,
                                  RowSums g_lrows = {}) {
  for (int j = 0; j < kCont; ++j) gin[j] = G[j];
  const Ray r{s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float inv_a = 1.0f / a;
  float best_t;
  int best_k;
  nearest_sphere(tbl, npad, r, a, inv_a, &best_t, &best_k);
  if constexpr (kTris)
    nearest_triangle_by<kSweep>(tris, r, npad, &best_t, &best_k, tally);
  const bool nee = kLit && L.n_lights > 0;

  if constexpr (kLit) {
    float v_t, v_alb[3];
    const int kv = L.n_vol > 0
                       ? volume_event(L, r, lane, salt, best_t, &v_t, v_alb)
                       : -1;
    if (kv >= 0) {  // before the miss: a ray under the sky still scatters
      if (bounce >= max_depth) return -1;  // absorbed: the identity
      volume_adjoint<kTris, kSweep>(tbl, npad, tris, L, s, r, kv, v_t, v_alb,
                                    nee, lane, salt, G, gin, g_lrows, tally);
      return -1;
    }
  }

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
  if constexpr (!kLit) {
    if (bounce >= max_depth) return -1;  // retired: the identity
  }

  const bool is_tri = kTris && best_k >= npad;
  Hit e;
  Material m0;
  if (is_tri) {
    e = triangle_hit_record(tris.tbl, best_k - npad, r);
    m0 = triangle_material(tris.tbl, best_k - npad);
  } else {
    e = hit_record(tbl, best_k, best_t, r, a, inv_a);
    m0 = sphere_material(tbl, best_k);
  }
  const bool tex = kLit && L.checker && !is_tri;
  const Material m = tex ? textured(tbl, best_k, m0, e.px, e.py, e.pz) : m0;
  float g_tm = 0.0f;
  if constexpr (kLit) {
    if (L.emissive && m.kind == kEmissive) {  // at any depth; no scatter
      float g_al[3];
      emission_adjoint<kSweep>(L, r, a, e.t, m, nee && from_diffuse, s, G,
                               gin, g_al, &g_tm, g_lrows);
      gin[6] += g_tm;
      const int c0 = is_tri ? 9 : 7;  // the albedo columns
      for (int c = 0; c < 3; ++c) gw[c0 + c] = g_al[c];
      return best_k;
    }
    if (bounce >= max_depth) return -1;
  }
  const Draws w = draw_scatter(lane, salt);
  const Scatter sc = scatter(m, e, r, a, w);
  ShadeGrad g = shade_adjoint(e, m, sc, w, r, s, G, gin);
  if (nee && is_diffuse(m.kind))
    next_event_adjoint<kTris, kSweep>(tbl, npad, tris, L, s, e.px, e.py,
                                      e.pz, e.nx, e.ny, e.nz, m.alr, m.alg,
                                      m.alb, false, lane, salt, G, gin, &g,
                                      &g_tm, g_lrows, tally);
  if (tex) texture_adjoint(tbl, best_k, m0, e, &g, gw);
  if (is_tri)
    triangle_hit_adjoint(tris.tbl, best_k - npad, e, r, g, gin, gw);
  else
    sphere_hit_adjoint(tbl, best_k, e, r, a, inv_a, g, G, gin, gw);
  gin[6] += g_tm;
  return best_k;
}

}  // namespace rtow
