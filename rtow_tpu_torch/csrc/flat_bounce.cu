// One bounce of L sorted lanes (K3), one thread per lane.
//
// Replaces rtow_tpu/ops/pallas_megakernel.py:_flat_bounce_kernel (:1739,
// launched by bounce_step_pallas :1838) for scenes of spheres and large
// meshes: the sorted-wavefront path (rtow_tpu_torch/ops/wavefront.py) calls
// it once per bounce.  The plain PyTorch version is bounce_step_reference in
// rtow_tpu_torch/ops/flat_bounce.py; the wrapper is bounce_step.
//
// State: one packed (16, L) float32 array, row-major: ox oy oz dx dy dz tm
// tpr tpg tpb rr rg rb, the alive code, the bounce count and the lane id
// (exact float32 integers).  A dead lane is copied through; a live lane runs
// bounce.cuh's bounce_lane_t<true> with the lane hash mix(lid * 0x9E3779B9)
// and the step salt mix(seed + it * 40503) (pallas_megakernel.py:1791-1792),
// computed by the launcher.
//
// What bounds it on Hopper: the triangle sweep's float32 work and the
// divergence of per-thread traversal, then the latency of the table reads.
// The table (65,536 rows x 64 B = 4 MB for the 65k knot, 23 MB for the 360k)
// cannot sit in shared memory but fits the 50 MB L2; the sort before every
// bounce keeps a warp's rays close in origin and direction, so its threads
// read the same blocks.  Each thread walks the hierarchy itself: hypers,
// supers, blocks as fixed-order nested loops with a slab test per box and
// its current best t (no stack), sweeping only the 128- or 256-row blocks
// its ray enters.  The sphere table sits in shared memory, as in K1.
// Front-to-back order and warp-cooperative traversal are later work.
//
// Scenes with lights, textures or media, and renders with roulette, run the
// lit instance (kLit, bounce_lane_t<true, true>, picked at run time as K1
// picks its lit instances): the alive code 2 after a diffuse or volume
// scatter under NEE, read back as from_diffuse = alive > 1
// (pallas_megakernel.py:1809); the light and volume rows staged in shared
// memory behind the sphere table.  The NEE shadow ray descends the same
// hierarchy from t_init = 0.999 of the light's distance (:1407-1416), so a
// shadow ray costs a second traversal, counted in the box and triangle
// tests and in `shadows`.  Two-sided triangles (cull = 0) run instances of
// their own (kTwoSided), picked at run time as the lit ones are: a side
// test read from the flag in the sweep's inner loop cost the unlit 65k
// knot's chunk 1.8% on an H100 (python -m rtow_tpu_torch.time_k3); 4
// instances in all.
//
// Numbers: float32 throughout with IEEE division and square root, built with
// -fmad=false, so every operation rounds as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce.cuh"

namespace {

constexpr int kThreads = 256;

// kLit: the lit bounce; lit.rows points at global memory here and is
// staged into shared memory.  kTwoSided: the triangles' side test, fixed at
// compile time.
template <bool kLit, bool kTwoSided>
__global__ void __launch_bounds__(kThreads)
    flat_bounce(const float4* __restrict__ table, int npad, rtow::Tris tris,
                const float* __restrict__ in, float* __restrict__ out, int n,
                uint32_t salt, int max_depth, rtow::Background bg,
                unsigned long long* __restrict__ stats,
                unsigned long long* __restrict__ shadows, rtow::Lit lit,
                int lit_rows) {
  tris.side_mask = kTwoSided ? rtow::kDropSign : rtow::kKeepSign;
  extern __shared__ float4 tbl[];  // npad sphere rows x 4 float4, lit rows
  for (int i = threadIdx.x; i < npad * 4; i += blockDim.x) tbl[i] = table[i];
  if constexpr (kLit) {
    float* rows = reinterpret_cast<float*>(tbl + npad * 4);
    for (int i = threadIdx.x; i < lit_rows * rtow::kLitCols; i += blockDim.x)
      rows[i] = lit.rows[i];
    lit.rows = rows;
  }
  __syncthreads();

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = static_cast<size_t>(n);
  rtow::Tally tally;
  int live = 0;
  if (g < n) {
    float s[rtow::kCont];
#pragma unroll
    for (int j = 0; j < rtow::kCont; ++j) s[j] = in[j * stride + g];
    int alive = static_cast<int>(in[13 * stride + g]);
    int bounce = static_cast<int>(in[14 * stride + g]);
    const float lid = in[15 * stride + g];
    if (alive > 0) {
      live = 1;
      alive = rtow::bounce_lane_t<true, kLit>(
          tbl, npad, tris, s, &bounce,
          rtow::lane_hash(static_cast<uint32_t>(static_cast<int>(lid))), salt,
          max_depth, bg, &tally, lit, alive > 1);
    }
#pragma unroll
    for (int j = 0; j < rtow::kCont; ++j) out[j * stride + g] = s[j];
    out[13 * stride + g] = static_cast<float>(alive);
    out[14 * stride + g] = static_cast<float>(bounce);
    out[15 * stride + g] = lid;
  }
  if (stats != nullptr) {  // box tests, triangle tests, live lanes
    rtow::warp_add(tally.boxes, stats);
    rtow::warp_add(tally.tris, stats + 1);
    rtow::warp_add(live, stats + 2);
  }
  if (kLit && shadows != nullptr)  // NEE shadow rays
    rtow::warp_add(tally.shadows, shadows);
}

}  // namespace

extern "C" {

// Launches one bounce of the n lanes of the (16, n) float32 state `in` into
// `out` on `stream`.  table: (npad, 16) float32 sphere rows, 16-byte aligned
// (npad may be 0); tri: (n_blocks * tri_block, 16) float32 rows, of which
// the first tri_count are triangles; boxes / supers / hypers: (n, 8) float32
// AABBs of the blocks, super-blocks and hyper-blocks (n_super / n_hyper 0
// where a level is absent); cull: 1 one-sided triangles, 0 two-sided; salt:
// the step salt; stats: null, or three uint64 that the launch adds its box
// tests, triangle tests and live lanes to; shadows: null, or one uint64 that
// it adds its NEE shadow rays to.  The lit features, as rtow_megakernel
// takes them: lit_rows, the light then volume rows (14 float32 each);
// emissive, checker, roulette flags; n_lights lights of kinds light_kinds
// and n_vol volumes of kinds vol_kinds from row vol_row0 (2 bits each, row
// 0 lowest).  Returns the cudaError_t of the launch.
int rtow_flat_bounce(const float* table, int npad, const float* tri,
                     const float* boxes, const float* supers,
                     const float* hypers, int n_blocks, int n_super,
                     int n_hyper, int tri_block, int tri_count, int cull,
                     const float* in, float* out, int n, uint32_t salt,
                     int max_depth, int use_sky, float bgr, float bgg,
                     float bgb, unsigned long long* stats,
                     unsigned long long* shadows, const float* lit_rows,
                     int emissive, int n_lights, int light_kinds, int checker,
                     int n_vol, int vol_kinds, int vol_row0, int roulette,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rtow::Lit lit{lit_rows, emissive, n_lights, checker, n_vol,
                      vol_row0, roulette,
                      static_cast<uint32_t>(light_kinds),
                      static_cast<uint32_t>(vol_kinds)};
  const int rows = n_vol > 0 ? vol_row0 + n_vol : n_lights;
  const bool any_lit =
      emissive || n_lights > 0 || n_vol > 0 || checker || roulette;
  auto kernel = any_lit ? flat_bounce<true, false> : flat_bounce<false, false>;
  if (!cull)
    kernel = any_lit ? flat_bounce<true, true> : flat_bounce<false, true>;
  const int smem = (npad * rtow::kCols + (any_lit ? rows * rtow::kLitCols
                                                  : 0)) *
                   static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rtow::Tris tris{reinterpret_cast<const float4*>(tri),
                        reinterpret_cast<const float4*>(boxes),
                        reinterpret_cast<const float4*>(supers),
                        reinterpret_cast<const float4*>(hypers),
                        n_blocks, n_super, n_hyper, tri_block, tri_count,
                        cull ? rtow::kKeepSign : rtow::kDropSign};
  const int blocks = (n + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), npad, tris, in, out, n, salt,
      max_depth, rtow::Background{use_sky, bgr, bgg, bgb}, stats, shadows,
      lit, rows);
  return static_cast<int>(cudaGetLastError());
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
