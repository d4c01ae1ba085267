// The gradient path's backward bounce, one thread per lane.
//
// Replaces rtow_tpu/ops/pallas_grad.py:_grad_bwd_kernel (K5, :224; launched
// by _bounce_grad_bwd :639) for spheres and triangles, the sky or a flat
// background, the Lambertian / metal / dielectric materials, emission,
// next-event estimation and checker / noise textures.  The plain PyTorch
// version is bounce_bwd_reference in rtow_tpu_torch/ops/grad.py (autograd
// through the plain shade); the wrapper is bounce_bwd there, called by the
// autograd Function BounceGrad.
//
// Contract: from K4's saved input state (cont (13, n) float32, ints (3, n)
// int32) and the output cotangents cot_out (13, n), write the input
// cotangents cot_in (13, n), add the sphere-table cotangent into g_tbl
// (npad, 16), for a scene with triangles the triangle-table cotangent into
// g_tri (Mpad, 16), and under NEE the light rows' cotangent into g_rows
// (n_rows, 14); the caller zeroes all three.  A dead lane passes its
// cotangents through.  A live lane replays K4's bounce -- the same sweeps,
// draws, light sample, shadow sweep and decisions, from bounce.cuh -- then
// runs the hand-written adjoint of the shade, of the lit features and of
// the winner's hit record (bounce_adjoint.cuh).  Its winner row's cotangent
// goes to that row of the table gradient of the winner's kind, for lanes
// that scattered or hit an emitter (a miss reads no row).  Four instances,
// as K4's: spheres only or spheres then triangles (flat or down the
// hierarchy), each unlit or lit, with the same optional `stats` as K4.
//
// What bounds it on Hopper: float32 ALU work, as in K4 (the replayed sweeps),
// plus the table-gradient sums.  Sphere lanes add their row cotangents into a
// per-block copy of the sphere-table gradient in shared memory (npad x 16
// floats: 32 KB for the cover), and each block then adds the non-zero
// entries of its copy to g_tbl with atomicAdd: one global atomic per touched
// entry per block instead of one per lane.  The light rows' cotangent (at
// most 16 x 14 floats) is summed the same way, in shared memory behind the
// staged light rows.  The triangle table's gradient (4 MB for a
// 65,536-triangle mesh, 23 MB for 360,448 rows) cannot sit in shared memory:
// a triangle lane adds each non-zero column of its row cotangent to g_tri
// with one global atomicAdd, 14 at most.  Sorted lanes put a warp's threads
// on the same few triangles, so these atomics contend; warp aggregation is
// later work.  The order of the atomics changes from run to run, so g_tbl,
// g_tri and g_rows are reproducible only to float32 rounding of the sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce.cuh"
#include "bounce_adjoint.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kTris, bool kLit>
__global__ void __launch_bounds__(kThreads)
    grad_bwd(const float4* __restrict__ table, int npad, rtow::Tris tris,
             const float* __restrict__ cont, const int* __restrict__ ints,
             const float* __restrict__ cot_out, int n, uint32_t salt,
             int max_depth, rtow::Background bg, float* __restrict__ cot_in,
             float* __restrict__ g_tbl, float* __restrict__ g_tri,
             float* __restrict__ g_rows,
             unsigned long long* __restrict__ stats, rtow::Lit lit,
             int lit_rows) {
  // npad x 4 float4 of table, npad x 16 of its gradient; then (kLit) the
  // light rows and their gradient, lit_rows x 14 floats each.
  extern __shared__ float4 smem[];
  float4* tbl = smem;
  float* acc = reinterpret_cast<float*>(smem + 4 * npad);
  float* lacc = acc + npad * rtow::kCols;
  for (int i = threadIdx.x; i < npad * 4; i += blockDim.x) tbl[i] = table[i];
  for (int i = threadIdx.x; i < npad * rtow::kCols; i += blockDim.x)
    acc[i] = 0.0f;
  if constexpr (kLit) {
    float* rows = lacc + lit_rows * rtow::kLitCols;
    for (int i = threadIdx.x; i < lit_rows * rtow::kLitCols; i += blockDim.x) {
      rows[i] = lit.rows[i];
      lacc[i] = 0.0f;
    }
    lit.rows = rows;
  }
  __syncthreads();

  constexpr int kSphCols = kLit ? rtow::kTexParamGrads : rtow::kParamGrads;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  rtow::Tally tally;
  int live = 0;
  if (g < n) {
    const size_t stride = static_cast<size_t>(n);
    float s[rtow::kCont], G[rtow::kCont], gin[rtow::kCont];
    float gw[rtow::kCols] = {};
#pragma unroll
    for (int j = 0; j < rtow::kCont; ++j) {
      s[j] = cont[j * stride + g];
      G[j] = cot_out[j * stride + g];
      gin[j] = G[j];
    }
    const int alive = ints[g];
    const int bounce = ints[stride + g];
    const uint32_t lid = static_cast<uint32_t>(ints[2 * stride + g]);
    int k = -1;
    if (alive > 0) {
      live = 1;
      k = rtow::bounce_lane_adjoint_t<kTris, kLit>(
          tbl, npad, tris, s, bounce, rtow::lane_hash(lid), salt, max_depth,
          bg, G, gin, gw, &tally, lit, alive > 1, lacc);
    }
#pragma unroll
    for (int j = 0; j < rtow::kCont; ++j) cot_in[j * stride + g] = gin[j];
    if (kTris && k >= npad) {
      float* row = g_tri + static_cast<size_t>(k - npad) * rtow::kCols;
#pragma unroll
      for (int c = 0; c < rtow::kTriParamGrads; ++c) {
        if (gw[c] != 0.0f) atomicAdd(&row[c], gw[c]);
      }
    } else if (k >= 0) {
#pragma unroll
      for (int c = 0; c < kSphCols; ++c) {
        if (gw[c] != 0.0f) atomicAdd(&acc[k * rtow::kCols + c], gw[c]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < npad * rtow::kCols; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(&g_tbl[i], v);
  }
  if constexpr (kLit) {
    for (int i = threadIdx.x; i < lit_rows * rtow::kLitCols; i += blockDim.x) {
      const float v = lacc[i];
      if (v != 0.0f) atomicAdd(&g_rows[i], v);
    }
  }
  if (stats != nullptr) {  // box tests, triangle tests, live lanes, shadows
    if constexpr (kTris) {
      rtow::warp_add(tally.boxes, stats);
      rtow::warp_add(tally.tris, stats + 1);
    }
    rtow::warp_add(live, stats + 2);
    if constexpr (kLit) rtow::warp_add(tally.shadows, stats + 3);
  }
}

template <bool kTris, bool kLit>
int launch(const float* table, int npad, const rtow::Tris& tris,
           const float* cont, const int* ints, const float* cot_out, int n,
           int it, int seed, int max_depth, const rtow::Background& bg,
           float* cot_in, float* g_tbl, float* g_tri, float* g_rows,
           unsigned long long* stats, const rtow::Lit& lit, int lit_rows,
           cudaStream_t stream) {
  auto kernel = grad_bwd<kTris, kLit>;
  const int smem = 2 * (npad * rtow::kCols +
                        (kLit ? lit_rows * rtow::kLitCols : 0)) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(table), npad, tris, cont, ints, cot_out,
      n, rtow::salt_of(seed, static_cast<uint32_t>(it)), max_depth, bg,
      cot_in, g_tbl, g_tri, g_rows, stats, lit, lit_rows);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTris>
int dispatch(bool any_lit, const float* table, int npad,
             const rtow::Tris& tris, const float* cont, const int* ints,
             const float* cot_out, int n, int it, int seed, int max_depth,
             const rtow::Background& bg, float* cot_in, float* g_tbl,
             float* g_tri, float* g_rows, unsigned long long* stats,
             const rtow::Lit& lit, int lit_rows, cudaStream_t stream) {
  auto run = any_lit ? launch<kTris, true> : launch<kTris, false>;
  return run(table, npad, tris, cont, ints, cot_out, n, it, seed, max_depth,
             bg, cot_in, g_tbl, g_tri, g_rows, stats, lit, lit_rows, stream);
}

}  // namespace

extern "C" {

// Launches one backward bounce of n lanes on `stream`.  table: (npad, 16)
// float32, 16-byte aligned (npad may be 0); tri .. tri_count: as for
// rtow_grad_fwd (tri null: the sphere instances); cont, cot_out, cot_in:
// (13, n) float32; ints: (3, n) int32; g_tbl: (npad, 16), g_tri
// (n_blocks * tri_block, 16) and g_rows (n_rows, 14) float32, zeroed by the
// caller (g_tri unused without triangles, g_rows without light rows);
// stats and the lit features: as for rtow_grad_fwd.  Returns the
// cudaError_t of the launch.
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
                  int checker, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rtow::Tris tris{reinterpret_cast<const float4*>(tri),
                        reinterpret_cast<const float4*>(boxes),
                        reinterpret_cast<const float4*>(supers),
                        reinterpret_cast<const float4*>(hypers),
                        n_blocks, n_super, n_hyper, tri_block, tri_count};
  const rtow::Background bg{use_sky, bgr, bgg, bgb};
  const rtow::Lit lit{lit_rows, emissive, n_lights, checker, 0, 0, 0,
                      static_cast<uint32_t>(light_kinds), 0u};
  const bool any_lit = emissive || n_lights > 0 || checker;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tri == nullptr)
    return dispatch<false>(any_lit, table, npad, tris, cont, ints, cot_out, n,
                           it, seed, max_depth, bg, cot_in, g_tbl, nullptr,
                           g_rows, stats, lit, n_rows, st);
  return dispatch<true>(any_lit, table, npad, tris, cont, ints, cot_out, n,
                        it, seed, max_depth, bg, cot_in, g_tbl, g_tri, g_rows,
                        stats, lit, n_rows, st);
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
