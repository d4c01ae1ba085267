// The gradient path's backward bounce, one thread per lane.
//
// Replaces rtow_tpu/ops/pallas_grad.py:_grad_bwd_kernel (K5, :224; launched
// by _bounce_grad_bwd :639) for spheres and triangles, the sky or a flat
// background, the Lambertian / metal / dielectric materials, emission,
// next-event estimation, checker / noise textures and constant-density
// media.  The plain PyTorch
// version is bounce_bwd_reference in rtow_tpu_torch/ops/grad.py (autograd
// through the plain shade); the wrapper is bounce_bwd there, called by the
// autograd Function BounceGrad.
//
// Contract: from K4's saved input state (cont (13, n) float32, ints (3, n)
// int32) and the output cotangents cot_out (13, n), write the input
// cotangents cot_in (13, n), add the sphere-table cotangent into g_tbl
// (npad, 16), for a scene with triangles the triangle-table cotangent into
// g_tri (Mpad, 16), and under NEE or with media the cotangent of the
// light rows and the volume rows behind them into g_rows (n_rows, 14);
// the caller zeroes all three.  A dead lane passes its
// cotangents through.  A live lane replays K4's bounce -- the same sweeps,
// draws, light sample, shadow sweep and decisions, from bounce.cuh -- then
// runs the hand-written adjoint of the shade, of the lit features and of
// the winner's hit record, or of the volume scatter where a free-flight
// event landed first (bounce_adjoint.cuh).  Its winner row's cotangent
// goes to that row of the table gradient of the winner's kind, for lanes
// that scattered off a surface or hit an emitter (a miss or a volume event
// reads no row).  Four instances,
// as K4's: spheres only or spheres then triangles (flat or down the
// hierarchy), each unlit or lit, with the same optional `stats` as K4.
//
// What bounds it on Hopper: float32 ALU work, as in K4 (the replayed sweeps),
// plus the table-gradient sums.  A float atomicAdd to shared memory is a
// compare-and-swap loop that contending threads repeat, and one to global
// memory is serialised per address at its L2 slice, so the sums are made
// in steps.  First the lanes of a warp on the same winner row sum their
// columns by shuffles where such a group has four or more (add_grouped:
// __match_any_sync on the row), and one lane of each group adds the sums.
// Those adds go to a per-block copy in shared memory of the sphere table's
// gradient (npad x 16 floats: 32 KB for the cover) and, where the caller's
// layout has room beside the sphere table (ops/grad.py's _bwd_layout: the
// Cornell and smoke boxes' 12-24 triangles), of the triangle table's.  The
// light and volume rows' cotangents go to each thread's own sums where
// the layout has room for them, else to the block's one copy.  Last each
// block adds the non-zero entries of its copies to g_tbl, g_rows and g_tri
// with atomicAdd: one global atomic per touched entry per block.  A larger
// triangle table's gradient (4 MB for a 65,536-triangle mesh, 23 MB for
// 360,448 rows) cannot sit in shared memory, so a group adds its sums to
// g_tri in global memory.  Measured on the Cornell box and the smoke box
// (PERF.md): the 2.56 M lanes' global atomics into 12-24 triangle rows took
// 57-85% of the 9 launches, the light and volume rows' shared atomics 28%
// on the smoke box with NEE.  The rotated boxes' frames (cos, sin) are
// derived once per block where the layout has room (rtow::stage_frames),
// not in every interval and its adjoint.  The order of the sums changes
// from run to run, so g_tbl, g_tri and g_rows are reproducible only to
// float32 rounding of the sums.
//
// The drain.  The mesh trainer sorts dead lanes last, and after the first
// bounces only a few warps at the head of a launch are live: in the thread
// form each of them walks its lane's triangle hierarchy alone while the
// card is mostly empty (the shape K3 had before its warp form).  The
// triangle instances therefore have a warp form too, grad_bwd_warp: one
// warp per live lane, its 32 threads sweeping the lane's triangles
// together (nearest_triangle_warp, as K3's warp form) and running the
// adjoint on the same inputs, lane 0 alone writing.  Which form runs is
// decided on the card: the launcher issues both, each block reads a device
// count of the live lanes, and the form that does not run exits at once,
// so the host needs no sync.

#include <cuda_runtime.h>
#include <stdint.h>

// The rotated boxes' frames, staged once a block (Lit::frames): this
// kernel's alone.  In every kernel the field and vol_frame's branch cost
// K4 up to 2.5% on the smoke box (PERF.md).
#define RTOW_STAGED_FRAMES 1
#include "bounce.cuh"
#include "bounce_adjoint.cuh"

namespace {

constexpr int kThreads = 256;

using rtow::warp_form_runs;

// What a block keeps in shared memory beyond the sphere table, its
// gradient, the light and volume rows and one copy of their sums, as the
// caller lays it out to fit beside the sphere table (ops/grad.py's
// _bwd_layout): tri_rows > 0, the triangle table's gradient (tri_rows x
// 16 floats) summed per block; own > 0, each thread's own sums of the
// rows, own floats apart (odd, so that neighbouring threads' copies fall
// in different banks), in place of the one copy; frames, the volumes'
// (cos, sin).  The warp form takes frames alone.
struct Layout {
  int tri_rows, own, frames;
};

// A block's shared memory: the sphere table (npad x 4 float4) and its
// gradient (npad x 16 floats); with kLit the rows' sums (lit_rows x 14
// floats, or kThreads x own), the rows themselves (lit_rows x 14 floats)
// and, with frames, the volumes' frames (2 n_vol floats); then the
// triangle table's gradient (tri_rows x 16 floats).
template <bool kLit>
int smem_bytes(int npad, int lit_rows, int n_vol, const Layout& lay) {
  const int floats =
      2 * npad * rtow::kCols +
      (kLit ? (lay.own > 0 ? kThreads * lay.own : lit_rows * rtow::kLitCols) +
                  lit_rows * rtow::kLitCols + (lay.frames ? 2 * n_vol : 0)
            : 0) +
      lay.tri_rows * rtow::kCols;
  return floats * static_cast<int>(sizeof(float));
}

struct Staged {
  float4* tbl;
  float* acc;   // the sphere table's gradient
  float* lacc;  // the light and volume rows' gradient
  float* tacc;  // the triangle table's gradient (lay.tri_rows > 0)
};

// Stages the sphere table, the rows and, with lay.frames, the volumes'
// frames (lit->rows and lit->frames then point at the copies) and zeroes
// the gradients' copies.
template <bool kLit>
__device__ __forceinline__ Staged stage(const float4* table, int npad,
                                        rtow::Lit* lit, int lit_rows,
                                        const Layout& lay) {
  extern __shared__ float4 smem[];
  Staged S;
  S.tbl = smem;
  S.acc = reinterpret_cast<float*>(smem + 4 * npad);
  S.lacc = S.acc + npad * rtow::kCols;
  float* end = S.lacc;
  for (int i = threadIdx.x; i < npad * 4; i += blockDim.x) S.tbl[i] = table[i];
  for (int i = threadIdx.x; i < npad * rtow::kCols; i += blockDim.x)
    S.acc[i] = 0.0f;
  if constexpr (kLit) {
    const int sums =
        lay.own > 0 ? kThreads * lay.own : lit_rows * rtow::kLitCols;
    for (int i = threadIdx.x; i < sums; i += blockDim.x) S.lacc[i] = 0.0f;
    float* rows = S.lacc + sums;
    for (int i = threadIdx.x; i < lit_rows * rtow::kLitCols; i += blockDim.x)
      rows[i] = lit->rows[i];
    lit->rows = rows;
    end = rows + lit_rows * rtow::kLitCols;
    if (lay.frames) {
      __syncthreads();
      rtow::stage_frames(*lit, end, threadIdx.x, blockDim.x);
      lit->frames = end;
      end += 2 * lit->n_vol;
    }
  }
  S.tacc = end;
  for (int i = threadIdx.x; i < lay.tri_rows * rtow::kCols; i += blockDim.x)
    S.tacc[i] = 0.0f;
  __syncthreads();
  return S;
}

// Adds the block's sums to the gradients in global memory: each non-zero
// entry of the shared copies once (the threads' own row sums first summed
// in thread order).
template <bool kLit>
__device__ __forceinline__ void flush(const Staged& S, int npad,
                                      int lit_rows, const Layout& lay,
                                      float* g_tbl, float* g_tri,
                                      float* g_rows) {
  __syncthreads();
  for (int i = threadIdx.x; i < npad * rtow::kCols; i += blockDim.x) {
    const float v = S.acc[i];
    if (v != 0.0f) atomicAdd(&g_tbl[i], v);
  }
  if constexpr (kLit) {
    for (int i = threadIdx.x; i < lit_rows * rtow::kLitCols; i += blockDim.x) {
      float v = 0.0f;
      if (lay.own > 0) {
        for (int t = 0; t < kThreads; ++t) v += S.lacc[t * lay.own + i];
      } else {
        v = S.lacc[i];
      }
      if (v != 0.0f) atomicAdd(&g_rows[i], v);
    }
  }
  for (int i = threadIdx.x; i < lay.tri_rows * rtow::kCols;
       i += blockDim.x) {
    const float v = S.tacc[i];
    if (v != 0.0f) atomicAdd(&g_tri[i], v);
  }
}

// The thread form: one thread per lane.  A lane's winner-row cotangent is
// summed with those of the warp's other lanes on the same row
// (add_grouped) and added to the block's shared copy of its table's
// gradient, to g_tri itself where the layout has no copy of it
// (lay.tri_rows 0).  Its light and volume rows' cotangents go to the
// thread's own sums where the layout gives it some (lay.own > 0), else to
// the block's.  For the triangle instances where
// `live_count` is given, its blocks exit at once where the warp form runs
// the launch (warp_form_runs).
template <bool kTris, bool kLit>
__global__ void __launch_bounds__(kThreads)
    grad_bwd(const float4* __restrict__ table, int npad, rtow::Tris tris,
             const float* __restrict__ cont, const int* __restrict__ ints,
             const float* __restrict__ cot_out, int n, uint32_t salt,
             int max_depth, rtow::Background bg, float* __restrict__ cot_in,
             float* __restrict__ g_tbl, float* __restrict__ g_tri,
             float* __restrict__ g_rows,
             unsigned long long* __restrict__ stats, rtow::Lit lit,
             int lit_rows, Layout lay, const long long* live_count,
             int cut) {
  if constexpr (kTris) {
    if (warp_form_runs(live_count, cut)) return;
  }
  // One-sided triangles, as JAX's gradient (pallas_grad.py:910), fixed at
  // compile time: the sweep's side test then costs what the cull alone does.
  tris.side_mask = rtow::kKeepSign;
  const Staged S = stage<kLit>(table, npad, &lit, lit_rows, lay);

  // The winner row's columns: a sphere's kParamGrads (kTexParamGrads with
  // textures), a triangle's kTriParamGrads; the others stay 0.
  constexpr int kSphCols = kLit ? rtow::kTexParamGrads : rtow::kParamGrads;
  constexpr int kRowCols =
      kTris && rtow::kTriParamGrads > kSphCols ? rtow::kTriParamGrads
                                               : kSphCols;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  rtow::Tally tally;
  int live = 0;
  int k = -1;
  float gw[rtow::kCols] = {};
  if (g < n) {
    const size_t stride = static_cast<size_t>(n);
    float s[rtow::kCont], G[rtow::kCont], gin[rtow::kCont];
#pragma unroll
    for (int j = 0; j < rtow::kCont; ++j) {
      s[j] = cont[j * stride + g];
      G[j] = cot_out[j * stride + g];
      gin[j] = G[j];
    }
    const int alive = ints[g];
    const int bounce = ints[stride + g];
    const uint32_t lid = static_cast<uint32_t>(ints[2 * stride + g]);
    if (alive > 0) {
      live = 1;
      k = rtow::bounce_lane_adjoint_t<kTris, kLit>(
          S.tbl, npad, tris, s, bounce, rtow::lane_hash(lid), salt, max_depth,
          bg, G, gin, gw, &tally, lit, alive > 1,
          rtow::RowSums{lay.own > 0 ? S.lacc + threadIdx.x * lay.own : S.lacc,
                        lay.own > 0});
    }
#pragma unroll
    for (int j = 0; j < rtow::kCont; ++j) cot_in[j * stride + g] = gin[j];
  }
  // The whole warp, converged: the winner rows' sums, each group's by its
  // lowest thread, whose k is the group's.
  rtow::add_grouped<kRowCols>(k, gw, [&](int c, float x) {
    if (kTris && k >= npad) {
      const int i = (k - npad) * rtow::kCols + c;
      if (lay.tri_rows > 0)
        atomicAdd(&S.tacc[i], x);
      else
        atomicAdd(&g_tri[i], x);
    } else {
      atomicAdd(&S.acc[k * rtow::kCols + c], x);
    }
  });
  flush<kLit>(S, npad, lit_rows, lay, g_tbl, g_tri, g_rows);
  if (stats != nullptr) {  // box tests, triangle tests, live lanes, shadows
    if constexpr (kTris) {
      rtow::warp_add(tally.boxes, stats);
      rtow::warp_add(tally.tris, stats + 1);
    }
    rtow::warp_add(live, stats + 2);
    if constexpr (kLit) rtow::warp_add(tally.shadows, stats + 3);
  }
}

// The warp form of the triangle instances, for a launch whose live lanes
// are few (the sorted drain): one warp per live lane.  The grid holds the
// warps the card runs at once; its threads first copy the dead lanes'
// cotangents through, then warp w takes lanes w, w + n_warps, ... and for
// each live one the 32 threads replay it together, sweeping its triangles
// as one (nearest_triangle_warp, bit-identical to the serial sweep) and
// running the adjoint on the same inputs, so its branches are uniform.
// Lane 0 alone writes the lane's cot_in, adds its row cotangent to the
// shared g_tbl copy or to g_tri (in global memory: few lanes contend), adds
// to the light rows' sums and counts the lane's work.
template <bool kLit>
__global__ void __launch_bounds__(kThreads)
    grad_bwd_warp(const float4* __restrict__ table, int npad, rtow::Tris tris,
                  const float* __restrict__ cont, const int* __restrict__ ints,
                  const float* __restrict__ cot_out, int n, uint32_t salt,
                  int max_depth, rtow::Background bg,
                  float* __restrict__ cot_in, float* __restrict__ g_tbl,
                  float* __restrict__ g_tri, float* __restrict__ g_rows,
                  unsigned long long* __restrict__ stats, rtow::Lit lit,
                  int lit_rows, Layout lay, const long long* live_count,
                  int cut) {
  if (!warp_form_runs(live_count, cut)) return;
  tris.side_mask = rtow::kKeepSign;
  const Staged S = stage<kLit>(table, npad, &lit, lit_rows, lay);

  constexpr int kSphCols = kLit ? rtow::kTexParamGrads : rtow::kParamGrads;
  const bool lead = (threadIdx.x & 31) == 0;
  const int n_threads = gridDim.x * kThreads;
  const int n_warps = n_threads / 32;
  const size_t stride = static_cast<size_t>(n);
  // Dead lanes pass their cotangents through, each thread its own lanes.
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < n; g += n_threads) {
    if (ints[g] > 0) continue;
#pragma unroll
    for (int j = 0; j < rtow::kCont; ++j)
      cot_in[j * stride + g] = cot_out[j * stride + g];
  }
  // Each live lane to one warp: warp w takes lanes w, w + n_warps, ...
  // (sorted lanes put the live ones at the head, spread over the warps),
  // its 32 threads reading 32 of them at once and the warp replaying the
  // live ones among them one after another.
  const int wl = threadIdx.x & 31;
  rtow::Tally tally;
  unsigned long long live = 0;
  for (int base = (blockIdx.x * kThreads + threadIdx.x) / 32; base < n;
       base += 32 * n_warps) {
    const int mine = base + wl * n_warps;
    const bool mine_live = mine < n && ints[mine] > 0;
    for (unsigned m = __ballot_sync(0xFFFFFFFFu, mine_live); m != 0u;
         m &= m - 1u) {
      const int g = base + (__ffs(static_cast<int>(m)) - 1) * n_warps;
      const int alive = ints[g];
      float s[rtow::kCont], G[rtow::kCont], gin[rtow::kCont];
      float gw[rtow::kCols] = {};
#pragma unroll
      for (int j = 0; j < rtow::kCont; ++j) {
        s[j] = cont[j * stride + g];
        G[j] = cot_out[j * stride + g];
      }
      const int bounce = ints[stride + g];
      const uint32_t lid = static_cast<uint32_t>(ints[2 * stride + g]);
      constexpr auto kWarp = rtow::Sweep::kWarp;
      const int k = rtow::bounce_lane_adjoint_t<true, kLit, kWarp>(
          S.tbl, npad, tris, s, bounce, rtow::lane_hash(lid), salt,
          max_depth, bg, G, gin, gw, &tally, lit, alive > 1,
          rtow::RowSums{S.lacc, false});
      if (lead) {
        ++live;
#pragma unroll
        for (int j = 0; j < rtow::kCont; ++j) cot_in[j * stride + g] = gin[j];
        if (k >= npad) {
          float* row = g_tri + static_cast<size_t>(k - npad) * rtow::kCols;
#pragma unroll
          for (int col = 0; col < rtow::kTriParamGrads; ++col) {
            if (gw[col] != 0.0f) atomicAdd(&row[col], gw[col]);
          }
        } else if (k >= 0) {
#pragma unroll
          for (int col = 0; col < kSphCols; ++col) {
            if (gw[col] != 0.0f)
              atomicAdd(&S.acc[k * rtow::kCols + col], gw[col]);
          }
        }
      }
    }
  }
  flush<kLit>(S, npad, lit_rows, lay, g_tbl, g_tri, g_rows);
  if (stats != nullptr) {  // the lanes' work, counted by lane 0 alone
    rtow::warp_add(lead ? tally.boxes : 0ull, stats);
    rtow::warp_add(lead ? tally.tris : 0ull, stats + 1);
    rtow::warp_add(live, stats + 2);
    if constexpr (kLit) rtow::warp_add(lead ? tally.shadows : 0ull, stats + 3);
  }
}

// Launches grad_bwd<kTris, kLit> over n lanes and, for the triangle
// instances where `live` is given, grad_bwd_warp<kLit> over the warps the
// card holds at once; each runs the lanes where the other exits (`cut`:
// the warp form takes launches of at most `cut` live lanes; cut >= n
// launches the warp form alone).  The thread form lays out its shared
// memory as `lay` says, the warp form with lay.frames alone.
template <bool kTris, bool kLit>
int launch(const float* table, int npad, const rtow::Tris& tris,
           const float* cont, const int* ints, const float* cot_out, int n,
           int it, int seed, int max_depth, const rtow::Background& bg,
           float* cot_in, float* g_tbl, float* g_tri, float* g_rows,
           unsigned long long* stats, const rtow::Lit& lit, int lit_rows,
           const Layout& lay, const long long* live, int cut,
           cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const uint32_t salt = rtow::salt_of(seed, static_cast<uint32_t>(it));
  const bool warp = kTris && live != nullptr;
  if (!warp || cut < n) {
    auto kernel = grad_bwd<kTris, kLit>;
    const int smem = smem_bytes<kLit>(npad, lit_rows, lit.n_vol, lay);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, kThreads, smem, stream>>>(
        reinterpret_cast<const float4*>(table), npad, tris, cont, ints,
        cot_out, n, salt, max_depth, bg, cot_in, g_tbl, g_tri, g_rows, stats,
        lit, lit_rows, lay, warp ? live : nullptr, cut);
    err = cudaGetLastError();
    if (err != cudaSuccess || !warp) return static_cast<int>(err);
  }
  auto kernel = grad_bwd_warp<kLit>;
  const Layout wl{0, 0, lay.frames};
  const int smem = smem_bytes<kLit>(npad, lit_rows, lit.n_vol, wl);
  int held = 0;
  cudaError_t err = rtow::resident_blocks(kernel, kThreads, smem, &held);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<held < blocks ? held : blocks, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(table), npad, tris, cont, ints, cot_out,
      n, salt, max_depth, bg, cot_in, g_tbl, g_tri, g_rows, stats, lit,
      lit_rows, wl, live, cut);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTris>
int dispatch(bool any_lit, const float* table, int npad,
             const rtow::Tris& tris, const float* cont, const int* ints,
             const float* cot_out, int n, int it, int seed, int max_depth,
             const rtow::Background& bg, float* cot_in, float* g_tbl,
             float* g_tri, float* g_rows, unsigned long long* stats,
             const rtow::Lit& lit, int lit_rows, const Layout& lay,
             const long long* live, int cut, cudaStream_t stream) {
  auto run = any_lit ? launch<kTris, true> : launch<kTris, false>;
  return run(table, npad, tris, cont, ints, cot_out, n, it, seed, max_depth,
             bg, cot_in, g_tbl, g_tri, g_rows, stats, lit, lit_rows, lay,
             live, cut, stream);
}

}  // namespace

extern "C" {

// Launches one backward bounce of n lanes on `stream`.  table: (npad, 16)
// float32, 16-byte aligned (npad may be 0); tri .. tri_count: as for
// rtow_grad_fwd (tri null: the sphere instances); cont, cot_out, cot_in:
// (13, n) float32; ints: (3, n) int32; g_tbl: (npad, 16), g_tri
// (n_blocks * tri_block, 16) and g_rows (n_rows, 14) float32, zeroed by the
// caller (g_tri unused without triangles, g_rows without rows);
// stats and the lit features: as for rtow_grad_fwd.  tri_rows, own and
// frames: the thread form's shared-memory layout (Layout), which the
// caller fits beside the sphere table (tri_rows 0 without triangles).
// live: null (the
// thread form), or for the triangle instances a device int64 holding the
// count of live lanes: the warp form then runs where it is at most cut
// (cut >= n: the warp form alone).  Returns the cudaError_t of the
// launches.
int rtow_grad_bwd(const float* table, int npad, const float* tri,
                  const float* boxes, const float* supers,
                  const float* hypers, int n_blocks, int n_super,
                  int n_hyper, int tri_block, int tri_count,
                  const float* cont, const int* ints, const float* cot_out,
                  int n, int it, int seed, int max_depth, int use_sky,
                  float bgr, float bgg, float bgb, float* cot_in,
                  float* g_tbl, float* g_tri, float* g_rows,
                  unsigned long long* stats, const float* lit_rows,
                  int n_rows, int emissive, int n_lights, int light_kinds,
                  int checker, int n_vol, int vol_kinds, int vol_row0,
                  int tri_rows, int own, int frames, const long long* live,
                  int cut, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rtow::Tris tris{reinterpret_cast<const float4*>(tri),
                        reinterpret_cast<const float4*>(boxes),
                        reinterpret_cast<const float4*>(supers),
                        reinterpret_cast<const float4*>(hypers),
                        n_blocks, n_super, n_hyper, tri_block, tri_count};
  const rtow::Background bg{use_sky, bgr, bgg, bgb};
  const rtow::Lit lit{lit_rows, emissive, n_lights, checker, n_vol,
                      vol_row0, 0, static_cast<uint32_t>(light_kinds),
                      static_cast<uint32_t>(vol_kinds)};
  const bool any_lit = emissive || n_lights > 0 || checker || n_vol > 0;
  const Layout lay{tri_rows, own, frames};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tri == nullptr)
    return dispatch<false>(any_lit, table, npad, tris, cont, ints, cot_out, n,
                           it, seed, max_depth, bg, cot_in, g_tbl, nullptr,
                           g_rows, stats, lit, n_rows, lay, nullptr, cut, st);
  return dispatch<true>(any_lit, table, npad, tris, cont, ints, cot_out, n,
                        it, seed, max_depth, bg, cot_in, g_tbl, g_tri, g_rows,
                        stats, lit, n_rows, lay, live, cut, st);
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
