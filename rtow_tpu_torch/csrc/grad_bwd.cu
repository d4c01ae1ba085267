// The gradient path's backward bounce for sphere scenes, one thread per lane.
//
// Replaces rtow_tpu/ops/pallas_grad.py:_grad_bwd_kernel (K5, :224; launched
// by _bounce_grad_bwd :639) for spheres, the sky or a flat background, and
// the Lambertian / metal / dielectric materials.  The plain PyTorch version
// is bounce_bwd_reference in rtow_tpu_torch/ops/grad.py (autograd through the
// plain shade); the wrapper is bounce_bwd there, called by the autograd
// Function BounceGrad.
//
// Contract: from K4's saved input state (cont (13, n) float32, ints (3, n)
// int32) and the output cotangents cot_out (13, n), write the input
// cotangents cot_in (13, n) and add the sphere-table cotangent into g_tbl
// (npad, 16), which the caller zeroes.  A dead lane passes its cotangents
// through.  A live lane replays K4's bounce -- the same sweep, draws and
// decisions, from bounce.cuh -- then runs the hand-written adjoint of the
// shade (bounce_adjoint.cuh).  Its winner row's cotangent goes to that row of
// the table gradient, for lanes that scattered only (a miss reads no row).
//
// What bounds it on Hopper: float32 ALU work, as in K4 (the replayed sweep
// is ~25 operations per table row), plus the table-gradient sum.  Lanes add
// their row cotangents into a per-block copy of the table gradient in shared
// memory (npad x 16 floats: 32 KB for the cover), and each block then adds
// the non-zero entries of its copy to g_tbl with atomicAdd: one global
// atomic per touched entry per block instead of one per lane.  The order of
// the atomics changes from run to run, so g_tbl is reproducible only to
// float32 rounding of the sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce.cuh"
#include "bounce_adjoint.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    grad_bwd(const float4* __restrict__ table, int npad,
             const float* __restrict__ cont, const int* __restrict__ ints,
             const float* __restrict__ cot_out, int n, uint32_t salt,
             int max_depth, rtow::Background bg, float* __restrict__ cot_in,
             float* __restrict__ g_tbl) {
  extern __shared__ float4 smem[];
  float4* tbl = smem;                                   // npad x 4 float4
  float* acc = reinterpret_cast<float*>(smem + 4 * npad);  // npad x 16
  for (int i = threadIdx.x; i < npad * 4; i += blockDim.x) tbl[i] = table[i];
  for (int i = threadIdx.x; i < npad * rtow::kCols; i += blockDim.x)
    acc[i] = 0.0f;
  __syncthreads();

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n) {
    const size_t stride = static_cast<size_t>(n);
    float s[rtow::kCont], G[rtow::kCont], gin[rtow::kCont];
    float gw[rtow::kParamGrads];
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
      k = rtow::bounce_lane_adjoint(tbl, npad, s, bounce, rtow::lane_hash(lid),
                                    salt, max_depth, bg, G, gin, gw);
    }
#pragma unroll
    for (int j = 0; j < rtow::kCont; ++j) cot_in[j * stride + g] = gin[j];
    if (k >= 0) {
#pragma unroll
      for (int c = 0; c < rtow::kParamGrads; ++c) {
        if (gw[c] != 0.0f) atomicAdd(&acc[k * rtow::kCols + c], gw[c]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < npad * rtow::kCols; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(&g_tbl[i], v);
  }
}

}  // namespace

extern "C" {

// Launches one backward bounce of n lanes on `stream`.  table: (npad, 16)
// float32, 16-byte aligned; cont, cot_out, cot_in: (13, n) float32; ints:
// (3, n) int32; g_tbl: (npad, 16) float32, zeroed by the caller.  Returns
// the cudaError_t of the launch.
int rtow_grad_bwd(const float* table, int npad, const float* cont,
                  const int* ints, const float* cot_out, int n, int it,
                  int seed, int max_depth, int use_sky, float bgr, float bgg,
                  float bgb, float* cot_in, float* g_tbl, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 2 * npad * rtow::kCols * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(grad_bwd,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  grad_bwd<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), npad, cont, ints, cot_out, n,
      rtow::salt_of(seed, static_cast<uint32_t>(it)), max_depth,
      rtow::Background{use_sky, bgr, bgg, bgb}, cot_in, g_tbl);
  return static_cast<int>(cudaGetLastError());
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
