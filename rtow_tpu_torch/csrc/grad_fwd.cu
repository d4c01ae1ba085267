// The gradient path's forward bounce, one thread per lane.
//
// Replaces rtow_tpu/ops/pallas_grad.py:_grad_fwd_kernel (K4, :101; launched
// by _bounce_fwd_impl :592) for spheres and triangles, the sky or a flat
// background, and the Lambertian / metal / dielectric materials.  The plain
// PyTorch version is bounce_fwd_reference in rtow_tpu_torch/ops/grad.py; the
// wrapper is bounce_fwd there, called once per bounce by the autograd
// Function BounceGrad.
//
// Contract (the JAX kernel's, on (13, n) and (3, n) arrays in place of 16
// arrays of n): cont = ox oy oz dx dy dz tm tpr tpg tpb rr rg rb float32,
// ints = alive bounce lid int32.  A dead lane (alive 0) is copied through.
// A live lane is advanced one bounce by rtow::bounce_lane_t (bounce.cuh, the
// code K1 and K3 run): alive becomes `can`, bounce counts the scatters, tm
// and lid pass through.  The counter RNG is salted with the scan step `it`,
// the same for every lane: lane = mix(lid * 0x9E3779B9),
// salt = mix(seed + it*40503).
//
// Two instances.  The sphere instance sweeps the sphere table only.  The
// triangle instance (a scene with triangles) sweeps the spheres, then the
// triangle table: its block boxes flat, or down the super / hyper hierarchy
// where the caller passes one (n_super > 0), exactly as K3 does; winner ids
// are npad + row.  It counts its box tests, triangle tests and live lanes
// into `stats` where the caller asks (one atomic per warp and counter).
//
// What bounds it on Hopper: float32 ALU work, not bytes.  A live lane sweeps
// all npad sphere rows (~25 operations each: 12,800 for the cover's 512
// rows) and, with triangles, the boxes and blocks its ray enters, while it
// moves 2 x 64 bytes of state.  The sphere table sits in shared memory and
// is read as broadcast 16-byte loads (npad may be 0: no shared memory); the
// triangle table stays in global memory, read through L2; a lane keeps its
// state in registers; a warp whose 32 lanes are all dead takes the copy
// branch only, the counterpart of the Pallas kernel's drained-tile skip
// (:132-146).
//
// Numbers: built with -fmad=false, IEEE division and sqrt, so the output is
// bit-identical to the plain version on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kTris>
__global__ void __launch_bounds__(kThreads)
    grad_fwd(const float4* __restrict__ table, int npad, rtow::Tris tris,
             const float* __restrict__ cont, const int* __restrict__ ints,
             int n, uint32_t salt, int max_depth, rtow::Background bg,
             float* __restrict__ cont_out, int* __restrict__ ints_out,
             unsigned long long* __restrict__ stats) {
  extern __shared__ float4 tbl[];  // npad rows x 4 float4
  for (int i = threadIdx.x; i < npad * 4; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  rtow::Tally tally;
  int live = 0;
  if (g < n) {
    const size_t stride = static_cast<size_t>(n);
    float s[rtow::kCont];
#pragma unroll
    for (int j = 0; j < rtow::kCont; ++j) s[j] = cont[j * stride + g];
    int alive = ints[g];
    int bounce = ints[stride + g];
    const int lid = ints[2 * stride + g];
    if (alive > 0) {
      live = 1;
      alive = rtow::bounce_lane_t<kTris>(
          tbl, npad, tris, s, &bounce,
          rtow::lane_hash(static_cast<uint32_t>(lid)), salt, max_depth, bg,
          &tally);
    }
#pragma unroll
    for (int j = 0; j < rtow::kCont; ++j) cont_out[j * stride + g] = s[j];
    ints_out[g] = alive;
    ints_out[stride + g] = bounce;
    ints_out[2 * stride + g] = lid;
  }
  if constexpr (kTris) {
    if (stats != nullptr) {  // box tests, triangle tests, live lanes
      rtow::warp_add(tally.boxes, stats);
      rtow::warp_add(tally.tris, stats + 1);
      rtow::warp_add(live, stats + 2);
    }
  }
}

template <bool kTris>
int launch(const float* table, int npad, const rtow::Tris& tris,
           const float* cont, const int* ints, int n, int it, int seed,
           int max_depth, const rtow::Background& bg, float* cont_out,
           int* ints_out, unsigned long long* stats, cudaStream_t stream) {
  const int smem = npad * rtow::kCols * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      grad_fwd<kTris>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  grad_fwd<kTris><<<blocks, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(table), npad, tris, cont, ints, n,
      rtow::salt_of(seed, static_cast<uint32_t>(it)), max_depth, bg,
      cont_out, ints_out, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches one forward bounce of n lanes on `stream`.  table: (npad, 16)
// float32 sphere rows, 16-byte aligned (npad may be 0); tri: null for a
// scene without triangles (the sphere instance), else the (n_blocks *
// tri_block, 16) float32 triangle rows, of which the first tri_count are
// triangles, with boxes / supers / hypers the (n, 8) float32 AABBs of the
// blocks, super-blocks and hyper-blocks (n_super / n_hyper 0 where a level
// is absent or the flat sweep is asked for); cont, cont_out: (13, n)
// float32; ints, ints_out: (3, n) int32; stats: null, or three uint64 that
// the triangle instance adds its box tests, triangle tests and live lanes
// to.  Returns the cudaError_t of the launch.
int rtow_grad_fwd(const float* table, int npad, const float* tri,
                  const float* boxes, const float* supers,
                  const float* hypers, int n_blocks, int n_super,
                  int n_hyper, int tri_block, int tri_count,
                  const float* cont, const int* ints, int n, int it, int seed,
                  int max_depth, int use_sky, float bgr, float bgg, float bgb,
                  float* cont_out, int* ints_out, unsigned long long* stats,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rtow::Tris tris{reinterpret_cast<const float4*>(tri),
                        reinterpret_cast<const float4*>(boxes),
                        reinterpret_cast<const float4*>(supers),
                        reinterpret_cast<const float4*>(hypers),
                        n_blocks, n_super, n_hyper, tri_block, tri_count};
  const rtow::Background bg{use_sky, bgr, bgg, bgb};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tri == nullptr)
    return launch<false>(table, npad, tris, cont, ints, n, it, seed,
                         max_depth, bg, cont_out, ints_out, nullptr, st);
  return launch<true>(table, npad, tris, cont, ints, n, it, seed, max_depth,
                      bg, cont_out, ints_out, stats, st);
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
