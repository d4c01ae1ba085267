// The gradient path's forward bounce, one thread per lane.
//
// Replaces rtow_tpu/ops/pallas_grad.py:_grad_fwd_kernel (K4, :101; launched
// by _bounce_fwd_impl :592) for spheres and triangles, the sky or a flat
// background, the Lambertian / metal / dielectric materials, emission,
// next-event estimation, checker / noise textures and constant-density
// media.  The plain PyTorch
// version is bounce_fwd_reference in rtow_tpu_torch/ops/grad.py; the wrapper
// is bounce_fwd there, called once per bounce by the autograd Function
// BounceGrad.
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
// Four instances: spheres only or spheres then triangles, each unlit or lit.
// The triangle instances sweep the spheres, then the triangle table: its
// block boxes flat, or down the super / hyper hierarchy where the caller
// passes one (n_super > 0), exactly as K3 does; winner ids are npad + row.
// The lit instances (a scene with an emissive, checker or noise material,
// or media)
// run K1's lit bounce, bounce_lane_t<kTris, true>, with the light rows
// staged in shared memory behind the sphere table: emission with its MIS
// weight (the input alive code 2 marks a diffuse scatter), next-event
// estimation toward the n_lights rows (0 without nee=True) with the shadow
// sweep from t_init = the light's distance less 0.1% and the shadow ray's
// medium transmittance, the textures, and constant-density media (the
// free-flight event before the surface, pallas_grad.py:165-178: an event
// at depth ends the lane, a volume scatter leaves alive 2 under NEE and 1
// without, the volume rows staged behind the light rows); alive becomes the
// code {0, 1, 2}.  No roulette: the JAX gradient path has none.  Each counts its box tests, triangle
// tests (the shadow sweeps' included), live lanes and shadow rays into
// `stats` where the caller asks (one atomic per warp and counter).
//
// What bounds it on Hopper: float32 ALU work, not bytes.  A live lane sweeps
// all npad sphere rows (~25 operations each: 12,800 for the cover's 512
// rows) and, with triangles, the boxes and blocks its ray enters, while it
// moves 2 x 64 bytes of state; a lit lane at a diffuse hit sweeps again for
// its shadow ray.  The sphere table sits in shared memory and is read as
// broadcast 16-byte loads (npad may be 0: no shared memory); the triangle
// table stays in global memory, read through L2; a lane keeps its state in
// registers; a warp whose 32 lanes are all dead takes the copy branch only,
// the counterpart of the Pallas kernel's drained-tile skip (:132-146).
//
// Numbers: built with -fmad=false, IEEE division and sqrt, so the output is
// bit-identical to the plain version on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce.cuh"

namespace {

constexpr int kThreads = 256;

// kLit: the lit bounce; lit.rows points at global memory here and is staged
// into shared memory.
template <bool kTris, bool kLit>
__global__ void __launch_bounds__(kThreads)
    grad_fwd(const float4* __restrict__ table, int npad, rtow::Tris tris,
             const float* __restrict__ cont, const int* __restrict__ ints,
             int n, uint32_t salt, int max_depth, rtow::Background bg,
             float* __restrict__ cont_out, int* __restrict__ ints_out,
             unsigned long long* __restrict__ stats, rtow::Lit lit,
             int lit_rows) {
  // One-sided triangles, as JAX's gradient (pallas_grad.py:910), fixed at
  // compile time: the sweep's side test then costs what the cull alone does.
  tris.side_mask = rtow::kKeepSign;
  extern __shared__ float4 tbl[];  // npad rows x 4 float4, then lit rows
  for (int i = threadIdx.x; i < npad * 4; i += blockDim.x) tbl[i] = table[i];
  if constexpr (kLit) {
    float* rows = reinterpret_cast<float*>(tbl + npad * 4);
    for (int i = threadIdx.x; i < lit_rows * rtow::kLitCols; i += blockDim.x)
      rows[i] = lit.rows[i];
    lit.rows = rows;
  }
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
      alive = rtow::bounce_lane_t<kTris, kLit>(
          tbl, npad, tris, s, &bounce,
          rtow::lane_hash(static_cast<uint32_t>(lid)), salt, max_depth, bg,
          &tally, lit, alive > 1);
    }
#pragma unroll
    for (int j = 0; j < rtow::kCont; ++j) cont_out[j * stride + g] = s[j];
    ints_out[g] = alive;
    ints_out[stride + g] = bounce;
    ints_out[2 * stride + g] = lid;
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
           const float* cont, const int* ints, int n, int it, int seed,
           int max_depth, const rtow::Background& bg, float* cont_out,
           int* ints_out, unsigned long long* stats, const rtow::Lit& lit,
           int lit_rows, cudaStream_t stream) {
  auto kernel = grad_fwd<kTris, kLit>;
  const int smem = (npad * rtow::kCols + (kLit ? lit_rows * rtow::kLitCols
                                               : 0)) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(table), npad, tris, cont, ints, n,
      rtow::salt_of(seed, static_cast<uint32_t>(it)), max_depth, bg,
      cont_out, ints_out, stats, lit, lit_rows);
  return static_cast<int>(cudaGetLastError());
}

// The instance for the scene: with or without triangles, lit where the
// scene has any lit feature.
template <bool kTris>
int dispatch(bool any_lit, const float* table, int npad,
             const rtow::Tris& tris, const float* cont, const int* ints,
             int n, int it, int seed, int max_depth,
             const rtow::Background& bg, float* cont_out, int* ints_out,
             unsigned long long* stats, const rtow::Lit& lit, int lit_rows,
             cudaStream_t stream) {
  auto run = any_lit ? launch<kTris, true> : launch<kTris, false>;
  return run(table, npad, tris, cont, ints, n, it, seed, max_depth, bg,
             cont_out, ints_out, stats, lit, lit_rows, stream);
}

}  // namespace

extern "C" {

// Launches one forward bounce of n lanes on `stream`.  table: (npad, 16)
// float32 sphere rows, 16-byte aligned (npad may be 0); tri: null for a
// scene without triangles (the sphere instances), else the (n_blocks *
// tri_block, 16) float32 triangle rows, of which the first tri_count are
// triangles, with boxes / supers / hypers the (n, 8) float32 AABBs of the
// blocks, super-blocks and hyper-blocks (n_super / n_hyper 0 where a level
// is absent or the flat sweep is asked for); cont, cont_out: (13, n)
// float32; ints, ints_out: (3, n) int32; stats: null, or four uint64 that
// the launch adds its box tests, triangle tests, live lanes and NEE shadow
// rays to.  The lit features: lit_rows,
// the (n_rows, 14) float32 light rows, then volume rows (null with
// neither); the emissive and checker flags; n_lights lights of kinds
// light_kinds (2 bits each, row 0 lowest: 0 sphere, 1 triangle); n_vol
// volumes of kinds vol_kinds (2 bits each: 0 sphere, 1 box, 2 rotated box)
// in the rows from vol_row0 on.  Returns the cudaError_t of the launch.
int rtow_grad_fwd(const float* table, int npad, const float* tri,
                  const float* boxes, const float* supers,
                  const float* hypers, int n_blocks, int n_super,
                  int n_hyper, int tri_block, int tri_count,
                  const float* cont, const int* ints, int n, int it, int seed,
                  int max_depth, int use_sky, float bgr, float bgg, float bgb,
                  float* cont_out, int* ints_out, unsigned long long* stats,
                  const float* lit_rows, int n_rows, int emissive,
                  int n_lights, int light_kinds, int checker, int n_vol,
                  int vol_kinds, int vol_row0, int device, void* stream) {
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tri == nullptr)
    return dispatch<false>(any_lit, table, npad, tris, cont, ints, n, it,
                           seed, max_depth, bg, cont_out, ints_out, stats, lit,
                           n_rows, st);
  return dispatch<true>(any_lit, table, npad, tris, cont, ints, n, it, seed,
                        max_depth, bg, cont_out, ints_out, stats, lit,
                        n_rows, st);
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
