// A host build of the kernels' per-lane code: K4's bounce
// (rtow::bounce_lane_t) and K5's adjoint (rtow::bounce_lane_adjoint_t), each
// in its thread and warp forms, in plain loops over lanes, and the triangle
// sweep of K3's two forms
// (rtow::nearest_triangle, and rtow::nearest_triangle_warp with the warp's
// 32 lanes played one after another), and the sorted lanes' keys
// (sort_keys.cuh: the live range, then each lane's key), for the CPU.
//
// The lane code in bounce.cuh and bounce_adjoint.cuh is plain C++ inside
// RTOW_HD functions; defining RTOW_HD as `inline` and a float4 of four
// floats before including the headers compiles the same arithmetic for the
// host.  Built with g++ -O2 -std=c++17 -ffp-contract=off (no multiply-add
// contraction, as the kernels' -fmad=false), every operation rounds as on
// the card, apart from libm's sinf / cosf against the card's.  The test
// tests/test_torch_lanes_host.py builds it and holds its lanes against the
// plain PyTorch versions in rtow_tpu_torch/ops/grad.py: K4's outputs lane
// by lane, and K5's input cotangents and row cotangents (sphere, triangle,
// light and volume) lane by lane, where the card's K5 sums the row
// cotangents with atomics before anything can compare them;
// tests/test_torch_k3_warp.py holds the warp's sweep to the serial one, and
// tests/test_torch_k4_warp.py and tests/test_torch_k5_warp.py K4's and K5's
// warp forms to their thread forms.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -o lanes.so host_lanes.cpp

#include <stdint.h>

#define RTOW_HD inline
struct float4 {
  float x, y, z, w;
};

#include "bounce.cuh"
#include "bounce_adjoint.cuh"
#include "sort_keys.cuh"

namespace {

rtow::Tris tris_of(const float* tri, const float* boxes, const float* supers,
                   const float* hypers, int n_blocks, int n_super,
                   int n_hyper, int tri_block, int tri_count) {
  return rtow::Tris{reinterpret_cast<const float4*>(tri),
                    reinterpret_cast<const float4*>(boxes),
                    reinterpret_cast<const float4*>(supers),
                    reinterpret_cast<const float4*>(hypers),
                    n_blocks, n_super, n_hyper, tri_block, tri_count};
}

template <bool kTris, bool kLit, rtow::Sweep kSweep>
void fwd_lanes(const float4* tbl, int npad, const rtow::Tris& tris,
               const float* cont, const int* ints, int n, uint32_t salt,
               int max_depth, const rtow::Background& bg, const rtow::Lit& L,
               float* cont_out, int* ints_out, unsigned long long* stats) {
  rtow::Tally tally;
  unsigned long long live = 0;
  for (int g = 0; g < n; ++g) {
    float s[rtow::kCont];
    for (int j = 0; j < rtow::kCont; ++j) s[j] = cont[j * n + g];
    int alive = ints[g];
    int bounce = ints[n + g];
    const int lid = ints[2 * n + g];
    if (alive > 0) {
      ++live;
      alive = rtow::bounce_lane_t<kTris, kLit, kSweep>(
          tbl, npad, tris, s, &bounce,
          rtow::lane_hash(static_cast<uint32_t>(lid)), salt, max_depth, bg,
          &tally, L, alive > 1);
    }
    for (int j = 0; j < rtow::kCont; ++j) cont_out[j * n + g] = s[j];
    ints_out[g] = alive;
    ints_out[n + g] = bounce;
    ints_out[2 * n + g] = lid;
  }
  stats[0] += tally.boxes;
  stats[1] += tally.tris;
  stats[2] += live;
  stats[3] += tally.shadows;
}

template <bool kTris, bool kLit, rtow::Sweep kSweep>
void bwd_lanes(const float4* tbl, int npad, const rtow::Tris& tris,
               const float* cont, const int* ints, const float* cot_out,
               int n, uint32_t salt, int max_depth, const rtow::Background& bg,
               const rtow::Lit& L, int n_rows, float* cot_in, int* winner,
               float* gw, float* g_rows, unsigned long long* stats) {
  rtow::Tally tally;
  unsigned long long live = 0;
  for (int g = 0; g < n; ++g) {
    float s[rtow::kCont], G[rtow::kCont], gin[rtow::kCont];
    float* w = gw + static_cast<size_t>(g) * rtow::kCols;
    for (int c = 0; c < rtow::kCols; ++c) w[c] = 0.0f;
    for (int j = 0; j < rtow::kCont; ++j) {
      s[j] = cont[j * n + g];
      G[j] = cot_out[j * n + g];
      gin[j] = G[j];
    }
    int k = -1;
    if (ints[g] > 0) {
      ++live;
      k = rtow::bounce_lane_adjoint_t<kTris, kLit, kSweep>(
          tbl, npad, tris, s, ints[n + g],
          rtow::lane_hash(static_cast<uint32_t>(ints[2 * n + g])), salt,
          max_depth, bg, G, gin, w, &tally, L, ints[g] > 1,
          rtow::RowSums{
              g_rows + static_cast<size_t>(g) * n_rows * rtow::kLitCols,
              true});
    }
    for (int j = 0; j < rtow::kCont; ++j) cot_in[j * n + g] = gin[j];
    winner[g] = k;
  }
  stats[0] += tally.boxes;
  stats[1] += tally.tris;
  stats[2] += live;
  stats[3] += tally.shadows;
}

}  // namespace

extern "C" {

// One forward bounce of n lanes, as rtow_grad_fwd launches it (the same
// arguments, stats (4,): box tests, triangle tests, live lanes, shadow
// rays, each added to).  warp 1 runs K4's warp form (bounce_lane_t under
// Sweep::kWarp, the warp's 32 lanes played in this one thread), 0 the
// thread form; cull 1 one-sided triangles, 0 two-sided.
void rtow_host_fwd_by(const float* table, int npad, const float* tri,
                      const float* boxes, const float* supers,
                      const float* hypers, int n_blocks, int n_super,
                      int n_hyper, int tri_block, int tri_count,
                      const float* cont, const int* ints, int n, int it,
                      int seed, int max_depth, int use_sky, float bgr,
                      float bgg, float bgb, float* cont_out, int* ints_out,
                      unsigned long long* stats, const float* lit_rows,
                      int emissive, int n_lights, int light_kinds,
                      int checker, int n_vol, int vol_kinds, int vol_row0,
                      int warp, int cull) {
  rtow::Tris tris = tris_of(tri, boxes, supers, hypers, n_blocks, n_super,
                            n_hyper, tri_block, tri_count);
  tris.side_mask = cull ? rtow::kKeepSign : rtow::kDropSign;
  const rtow::Background bg{use_sky, bgr, bgg, bgb};
  const rtow::Lit L{lit_rows, emissive, n_lights, checker, n_vol, vol_row0,
                    0, static_cast<uint32_t>(light_kinds),
                    static_cast<uint32_t>(vol_kinds)};
  const bool lit = emissive || n_lights > 0 || checker || n_vol > 0;
  const auto* tbl = reinterpret_cast<const float4*>(table);
  const uint32_t salt = rtow::salt_of(seed, static_cast<uint32_t>(it));
  constexpr auto kT = rtow::Sweep::kThread;
  constexpr auto kW = rtow::Sweep::kWarp;
  auto run = tri == nullptr ? (lit ? fwd_lanes<false, true, kT>
                                   : fwd_lanes<false, false, kT>)
                            : (lit ? fwd_lanes<true, true, kT>
                                   : fwd_lanes<true, false, kT>);
  if (tri != nullptr && warp)
    run = lit ? fwd_lanes<true, true, kW> : fwd_lanes<true, false, kW>;
  run(tbl, npad, tris, cont, ints, n, salt, max_depth, bg, L, cont_out,
      ints_out, stats);
}

// rtow_host_fwd_by's thread form on one-sided triangles.
void rtow_host_fwd(const float* table, int npad, const float* tri,
                   const float* boxes, const float* supers,
                   const float* hypers, int n_blocks, int n_super,
                   int n_hyper, int tri_block, int tri_count,
                   const float* cont, const int* ints, int n, int it,
                   int seed, int max_depth, int use_sky, float bgr, float bgg,
                   float bgb, float* cont_out, int* ints_out,
                   unsigned long long* stats, const float* lit_rows,
                   int emissive, int n_lights, int light_kinds, int checker,
                   int n_vol, int vol_kinds, int vol_row0) {
  rtow_host_fwd_by(table, npad, tri, boxes, supers, hypers, n_blocks,
                   n_super, n_hyper, tri_block, tri_count, cont, ints, n, it,
                   seed, max_depth, use_sky, bgr, bgg, bgb, cont_out,
                   ints_out, stats, lit_rows, emissive, n_lights, light_kinds,
                   checker, n_vol, vol_kinds, vol_row0, 0, 1);
}

// One backward bounce of n lanes, each lane's parts kept apart: cot_in
// (13, n); winner (n,): the winner id whose row the lane's cotangent gw
// (n, 16) belongs to (spheres 0 .. npad - 1, triangles npad + row), or -1;
// g_rows (n, n_rows, 14): the lane's cotangent of the light and volume
// rows, zeroed by the caller.  The other arguments as for rtow_host_fwd_by;
// warp 1 runs K5's warp form (bounce_lane_adjoint_t under Sweep::kWarp,
// the warp's 32 lanes played in this one thread), 0 the thread form; cull
// 1 one-sided triangles, 0 two-sided.
void rtow_host_bwd_by(const float* table, int npad, const float* tri,
                      const float* boxes, const float* supers,
                      const float* hypers, int n_blocks, int n_super,
                      int n_hyper, int tri_block, int tri_count,
                      const float* cont, const int* ints,
                      const float* cot_out, int n, int it, int seed,
                      int max_depth, int use_sky, float bgr, float bgg,
                      float bgb, float* cot_in, int* winner, float* gw,
                      float* g_rows, unsigned long long* stats,
                      const float* lit_rows, int n_rows, int emissive,
                      int n_lights, int light_kinds, int checker, int n_vol,
                      int vol_kinds, int vol_row0, int warp, int cull) {
  rtow::Tris tris = tris_of(tri, boxes, supers, hypers, n_blocks, n_super,
                            n_hyper, tri_block, tri_count);
  tris.side_mask = cull ? rtow::kKeepSign : rtow::kDropSign;
  const rtow::Background bg{use_sky, bgr, bgg, bgb};
  const rtow::Lit L{lit_rows, emissive, n_lights, checker, n_vol, vol_row0,
                    0, static_cast<uint32_t>(light_kinds),
                    static_cast<uint32_t>(vol_kinds)};
  const bool lit = emissive || n_lights > 0 || checker || n_vol > 0;
  const auto* tbl = reinterpret_cast<const float4*>(table);
  const uint32_t salt = rtow::salt_of(seed, static_cast<uint32_t>(it));
  constexpr auto kT = rtow::Sweep::kThread;
  constexpr auto kW = rtow::Sweep::kWarp;
  auto run = tri == nullptr ? (lit ? bwd_lanes<false, true, kT>
                                   : bwd_lanes<false, false, kT>)
                            : (lit ? bwd_lanes<true, true, kT>
                                   : bwd_lanes<true, false, kT>);
  if (tri != nullptr && warp)
    run = lit ? bwd_lanes<true, true, kW> : bwd_lanes<true, false, kW>;
  run(tbl, npad, tris, cont, ints, cot_out, n, salt, max_depth, bg, L, n_rows,
      cot_in, winner, gw, g_rows, stats);
}

// rtow_host_bwd_by's thread form on one-sided triangles.
void rtow_host_bwd(const float* table, int npad, const float* tri,
                   const float* boxes, const float* supers,
                   const float* hypers, int n_blocks, int n_super,
                   int n_hyper, int tri_block, int tri_count,
                   const float* cont, const int* ints, const float* cot_out,
                   int n, int it, int seed, int max_depth, int use_sky,
                   float bgr, float bgg, float bgb, float* cot_in,
                   int* winner, float* gw, float* g_rows,
                   unsigned long long* stats, const float* lit_rows,
                   int n_rows, int emissive, int n_lights, int light_kinds,
                   int checker, int n_vol, int vol_kinds, int vol_row0) {
  rtow_host_bwd_by(table, npad, tri, boxes, supers, hypers, n_blocks,
                   n_super, n_hyper, tri_block, tri_count, cont, ints,
                   cot_out, n, it, seed, max_depth, use_sky, bgr, bgg, bgb,
                   cot_in, winner, gw, g_rows, stats, lit_rows, n_rows,
                   emissive, n_lights, light_kinds, checker, n_vol,
                   vol_kinds, vol_row0, 0, 1);
}

// The triangle sweep alone for n rays: rays (7, n) float32 ox oy oz dx dy
// dz tm, t_init (n,) their starting best t.  warp 0 runs
// nearest_triangle, 1 nearest_triangle_warp; each ray's best t and winner
// row (-1: none) go to t_out and k_out, its box and triangle tests are
// added to stats (2,).  cull: 1 one-sided triangles, 0 two-sided.
void rtow_host_sweep(const float* tri, const float* boxes,
                     const float* supers, const float* hypers, int n_blocks,
                     int n_super, int n_hyper, int tri_block, int tri_count,
                     int cull, const float* rays, const float* t_init, int n,
                     int warp, float* t_out, int* k_out,
                     unsigned long long* stats) {
  rtow::Tris tris = tris_of(tri, boxes, supers, hypers, n_blocks, n_super,
                            n_hyper, tri_block, tri_count);
  tris.side_mask = cull ? rtow::kKeepSign : rtow::kDropSign;
  rtow::Tally tally;
  for (int g = 0; g < n; ++g) {
    const rtow::Ray r{rays[g], rays[n + g], rays[2 * n + g],
                      rays[3 * n + g], rays[4 * n + g], rays[5 * n + g],
                      rays[6 * n + g]};
    float bt = t_init[g];
    int bk = -1;
    if (warp)
      rtow::nearest_triangle_warp(tris, r, 0, &bt, &bk, &tally);
    else
      rtow::nearest_triangle(tris, r, 0, &bt, &bk, &tally);
    t_out[g] = bt;
    k_out[g] = bk;
  }
  stats[0] += tally.boxes;
  stats[1] += tally.tris;
}

// The sorted lanes' keys of n lanes, as rtow_sort_keys computes them (the
// same arguments, without the scratch): the live direction range over the
// lanes in order, then each lane's key.  alive_f32: 1 float32, 0 int32.
void rtow_host_sort_keys(const float* ray, long long stride,
                         const void* alive, int alive_f32, int n,
                         const float* bmin, const float* inv_ext,
                         long long* out) {
  namespace K = rtow::keys;
  auto live = [&](int g) {
    return alive_f32 ? static_cast<const float*>(alive)[g] > 0.0f
                     : static_cast<const int*>(alive)[g] > 0;
  };
  float lo[3] = {K::kBig, K::kBig, K::kBig};
  float hi[3] = {-K::kBig, -K::kBig, -K::kBig};
  for (int g = 0; g < n; ++g) {
    if (!live(g)) continue;
    float nd[3];
    K::unit_dir(ray[3 * stride + g], ray[4 * stride + g],
                ray[5 * stride + g], nd);
    for (int a = 0; a < 3; ++a) {
      lo[a] = K::min_nan(lo[a], nd[a]);
      hi[a] = K::max_nan(hi[a], nd[a]);
    }
  }
  float scale[3];
  for (int a = 0; a < 3; ++a) scale[a] = K::dir_scale(lo[a], hi[a]);
  for (int g = 0; g < n; ++g) {
    if (!live(g)) {
      out[g] = K::kDeadKey;
      continue;
    }
    const float o[3] = {ray[g], ray[stride + g], ray[2 * stride + g]};
    float nd[3];
    K::unit_dir(ray[3 * stride + g], ray[4 * stride + g],
                ray[5 * stride + g], nd);
    out[g] = K::lane_key(o, nd, bmin, inv_ext, lo, scale);
  }
}

}  // extern "C"
