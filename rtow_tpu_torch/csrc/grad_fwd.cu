// The gradient path's forward bounce for sphere scenes, one thread per lane.
//
// Replaces rtow_tpu/ops/pallas_grad.py:_grad_fwd_kernel (K4, :101; launched
// by _bounce_fwd_impl :592) for spheres, the sky or a flat background, and
// the Lambertian / metal / dielectric materials.  The plain PyTorch version
// is bounce_fwd_reference in rtow_tpu_torch/ops/grad.py; the wrapper is
// bounce_fwd there, called once per bounce by the autograd Function
// BounceGrad.
//
// Contract (the JAX kernel's, on (13, n) and (3, n) arrays in place of 16
// arrays of n): cont = ox oy oz dx dy dz tm tpr tpg tpb rr rg rb float32,
// ints = alive bounce lid int32.  A dead lane (alive 0) is copied through.
// A live lane is advanced one bounce by rtow::bounce_lane (bounce.cuh, the
// code K1 runs): alive becomes `can`, bounce counts the scatters, tm and lid
// pass through.  The counter RNG is salted with the scan step `it`, the same
// for every lane: lane = mix(lid * 0x9E3779B9), salt = mix(seed + it*40503).
//
// What bounds it on Hopper: float32 ALU work, not bytes.  A live lane sweeps
// all npad table rows (~25 operations each: 12,800 for the cover's 512 rows)
// while it moves 2 x 64 bytes of state.  The table sits in shared memory and
// is read as broadcast 16-byte loads; a lane keeps its state in registers; a
// warp whose 32 lanes are all dead takes the copy branch only, the
// counterpart of the Pallas kernel's drained-tile skip (:132-146).
//
// Numbers: built with -fmad=false, IEEE division and sqrt, so the output is
// bit-identical to the plain version on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    grad_fwd(const float4* __restrict__ table, int npad,
             const float* __restrict__ cont, const int* __restrict__ ints,
             int n, uint32_t salt, int max_depth, rtow::Background bg,
             float* __restrict__ cont_out, int* __restrict__ ints_out) {
  extern __shared__ float4 tbl[];  // npad rows x 4 float4
  for (int i = threadIdx.x; i < npad * 4; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const size_t stride = static_cast<size_t>(n);
  float s[rtow::kCont];
#pragma unroll
  for (int j = 0; j < rtow::kCont; ++j) s[j] = cont[j * stride + g];
  int alive = ints[g];
  int bounce = ints[stride + g];
  const int lid = ints[2 * stride + g];
  if (alive > 0) {
    alive = rtow::bounce_lane(tbl, npad, s, &bounce,
                              rtow::lane_hash(static_cast<uint32_t>(lid)),
                              salt, max_depth, bg);
  }
#pragma unroll
  for (int j = 0; j < rtow::kCont; ++j) cont_out[j * stride + g] = s[j];
  ints_out[g] = alive;
  ints_out[stride + g] = bounce;
  ints_out[2 * stride + g] = lid;
}

}  // namespace

extern "C" {

// Launches one forward bounce of n lanes on `stream`.  table: (npad, 16)
// float32, 16-byte aligned; cont, cont_out: (13, n) float32; ints, ints_out:
// (3, n) int32.  Returns the cudaError_t of the launch.
int rtow_grad_fwd(const float* table, int npad, const float* cont,
                  const int* ints, int n, int it, int seed, int max_depth,
                  int use_sky, float bgr, float bgg, float bgb,
                  float* cont_out, int* ints_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = npad * rtow::kCols * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(grad_fwd,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  grad_fwd<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), npad, cont, ints, n,
      rtow::salt_of(seed, static_cast<uint32_t>(it)), max_depth,
      rtow::Background{use_sky, bgr, bgg, bgb}, cont_out, ints_out);
  return static_cast<int>(cudaGetLastError());
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
