// One bounce of L sorted lanes (K3), in two forms: one thread per lane, or
// one warp per lane.
//
// Replaces rtow_tpu/ops/pallas_megakernel.py:_flat_bounce_kernel (:1739,
// launched by bounce_step_pallas :1838) for scenes of spheres and large
// meshes: the sorted-wavefront path (rtow_tpu_torch/ops/wavefront.py) calls
// it once per bounce.  The plain PyTorch version is bounce_step_reference in
// rtow_tpu_torch/ops/flat_bounce.py; the wrapper is bounce_step, which picks
// the form per launch from the live-lane count (WARP_MAX_LIVE there).
//
// State: one packed (16, L) float32 array, row-major: ox oy oz dx dy dz tm
// tpr tpg tpb rr rg rb, the alive code, the bounce count and the lane id
// (exact float32 integers).  A dead lane is copied through; a live lane runs
// bounce.cuh's bounce_lane_t<true> with the lane hash mix(lid * 0x9E3779B9)
// and the step salt mix(seed + it * 40503) (pallas_megakernel.py:1791-1792),
// computed by the launcher.
//
// What bounds the thread form (flat_bounce) on Hopper: latency.  Each
// thread walks the hierarchy itself (hypers, supers, blocks as fixed-order
// nested loops with a slab test per box and its current best t, no stack)
// and sweeps every block its ray enters brute force, 128 or 256 rows one
// after another: 800-2,000 dependent row reads from L2 per lane-bounce (the
// table, 4 MB for the 65k knot and 23 MB for the 360k, fits the 50 MB L2).
// The sort before every bounce keeps a warp's rays close, so its threads
// read the same blocks.  That serves the wide launches: the first of a
// 262,144-lane chunk of the 65k knot took 1.39 ms on an H100 (NVIDIA H100
// 80GB HBM3, 700 W).  Once the window holds a few thousand live lanes a
// launch is a handful of warps on a card of 132 SMs, each thread ~1,000
// serial L2 round trips: on the same card the launches of that chunk with
// 6,572, 3,213, ..., 32 live lanes took 5.2, 5.1, ..., 4.4 ms each (one of
// 1 lane 0.38 ms for 1,024 triangle tests, ~0.37 us a test), 52.1 of the
// chunk's 73.5 ms for 2.3% of its lane-bounces.
//
// The warp form (flat_bounce_warp) puts the 32 threads of a warp on one
// lane: bounce.cuh's nearest_triangle_warp slab-tests 32 boxes of a level at
// once and sweeps a block 32 rows at a time, lane j on rows j, 32 + j, ...,
// then takes the least (t, row) by shuffles: the serial walk's blocks, its
// (best t, winner) bit for bit and its counts, with a block's ~1,000
// dependent reads cut to 4 or 8 a thread.  Warps take the lanes grid-stride
// (lane g to warp g mod W, W warps the card holds at once), 32 at a time:
// each thread reads one alive code and copies its lane through if dead,
// and the warp bounces the live ones in order.  After the sort the live
// lanes are the window's prefix, so they spread evenly over the warps.  The
// rest of the bounce (the sphere sweep from shared memory, the shade, the
// draws, NEE with its shadow ray down nearest_triangle_warp) runs on all 32
// threads on the same inputs; lane 0 writes the lane and adds the warp's
// counts.  On the same card it took those launches to 0.12-0.22 ms each,
// and the chunk (its full first launch left to the thread form, which is
// faster there on unlit meshes: bounce_step's WARP_MAX_LIVE) from 72.6 to
// 4.4 ms.  Still to come (ROADMAP Queue 2b item 7): front-to-back order,
// so that the best t falls early and far boxes cull, and staging a block's
// rows in shared memory for the warps that enter it.
//
// Scenes with lights, textures or media, and renders with roulette, run the
// lit instances (kLit, bounce_lane_t<true, true>, picked at run time as K1
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
// instances of each form, 8 in all.
//
// Numbers: float32 throughout with IEEE division and square root, built with
// -fmad=false, so every operation rounds as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // a block's warps

// Stages the sphere table, and with kLit the light and volume rows (then
// pointed at from lit), into shared memory; every thread of the block
// calls it.
template <bool kLit>
__device__ __forceinline__ void stage(const float4* __restrict__ table,
                                      int npad, rtow::Lit* lit, int lit_rows,
                                      float4* tbl) {
  for (int i = threadIdx.x; i < npad * 4; i += blockDim.x) tbl[i] = table[i];
  if constexpr (kLit) {
    float* rows = reinterpret_cast<float*>(tbl + npad * 4);
    for (int i = threadIdx.x; i < lit_rows * rtow::kLitCols; i += blockDim.x)
      rows[i] = lit->rows[i];
    lit->rows = rows;
  }
  __syncthreads();
}

// The thread form: lane g on thread g.  kLit: the lit bounce; lit.rows
// points at global memory here and is staged into shared memory.
// kTwoSided: the triangles' side test, fixed at compile time.
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
  stage<kLit>(table, npad, &lit, lit_rows, tbl);

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

// The warp form: lane g on warp g mod W (W warps in the grid), the warp's
// lanes 32 at a time; its 32 threads run each live lane's bounce together
// (bounce_lane_t<true, kLit, Sweep::kWarp>) and thread 0 writes it.  Right
// for any state; fast where the live lanes are few, and where they are the
// prefix (a sorted state) they spread evenly over the warps.
template <bool kLit, bool kTwoSided>
__global__ void __launch_bounds__(kThreads)
    flat_bounce_warp(const float4* __restrict__ table, int npad,
                     rtow::Tris tris, const float* __restrict__ in,
                     float* __restrict__ out, int n, uint32_t salt,
                     int max_depth, rtow::Background bg,
                     unsigned long long* __restrict__ stats,
                     unsigned long long* __restrict__ shadows, rtow::Lit lit,
                     int lit_rows) {
  tris.side_mask = kTwoSided ? rtow::kDropSign : rtow::kKeepSign;
  extern __shared__ float4 tbl[];
  stage<kLit>(table, npad, &lit, lit_rows, tbl);

  const int lane = static_cast<int>(threadIdx.x & 31u);
  const int warps = static_cast<int>(gridDim.x) * kWarps;
  const size_t stride = static_cast<size_t>(n);
  rtow::Tally tally;
  unsigned long long live = 0;
  for (int g0 = blockIdx.x * kWarps + threadIdx.x / 32; g0 < n;
       g0 += rtow::Warp::kLanes * warps) {
    // This thread's lane of the 32: copied through here if dead.
    const int gj = g0 + lane * warps;
    const bool mine = gj < n;
    const bool alive_j = mine && static_cast<int>(in[13 * stride + gj]) > 0;
    if (mine && !alive_j) {
#pragma unroll
      for (int j = 0; j < 16; ++j) out[j * stride + gj] = in[j * stride + gj];
    }
    uint32_t m = __ballot_sync(0xFFFFFFFFu, alive_j);
    while (m != 0u) {  // the live ones, the whole warp on each
      const int g = g0 + (__ffs(static_cast<int>(m)) - 1) * warps;
      m &= m - 1u;
      float s[rtow::kCont];
#pragma unroll
      for (int j = 0; j < rtow::kCont; ++j) s[j] = in[j * stride + g];
      int alive = static_cast<int>(in[13 * stride + g]);
      int bounce = static_cast<int>(in[14 * stride + g]);
      const float lid = in[15 * stride + g];
      ++live;
      alive = rtow::bounce_lane_t<true, kLit, rtow::Sweep::kWarp>(
          tbl, npad, tris, s, &bounce,
          rtow::lane_hash(static_cast<uint32_t>(static_cast<int>(lid))), salt,
          max_depth, bg, &tally, lit, alive > 1);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < rtow::kCont; ++j) out[j * stride + g] = s[j];
        out[13 * stride + g] = static_cast<float>(alive);
        out[14 * stride + g] = static_cast<float>(bounce);
        out[15 * stride + g] = lid;
      }
    }
  }
  // Every thread of a warp holds the warp's counts: thread 0 adds them.
  if (lane == 0 && stats != nullptr) {
    atomicAdd(stats, tally.boxes);
    atomicAdd(stats + 1, tally.tris);
    atomicAdd(stats + 2, live);
  }
  if (kLit && lane == 0 && shadows != nullptr)
    atomicAdd(shadows, tally.shadows);
}

using Kernel = decltype(&flat_bounce<false, false>);

template <bool kLit, bool kTwoSided>
Kernel form(bool warp) {
  return warp ? flat_bounce_warp<kLit, kTwoSided>
              : flat_bounce<kLit, kTwoSided>;
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
// 0 lowest).  warp: 0 the thread form, 1 the warp form.  Returns the
// cudaError_t of the launch.
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
                     int warp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rtow::Lit lit{lit_rows, emissive, n_lights, checker, n_vol,
                      vol_row0, roulette,
                      static_cast<uint32_t>(light_kinds),
                      static_cast<uint32_t>(vol_kinds)};
  const int rows = n_vol > 0 ? vol_row0 + n_vol : n_lights;
  const bool any_lit =
      emissive || n_lights > 0 || n_vol > 0 || checker || roulette;
  const Kernel kernel =
      any_lit ? (cull ? form<true, false>(warp) : form<true, true>(warp))
              : (cull ? form<false, false>(warp) : form<false, true>(warp));
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
  int blocks = (n + kThreads - 1) / kThreads;
  if (warp) {  // a warp a lane, at most the warps the card holds at once
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int held = (per_sm > 0 ? per_sm : 1) * sms;
    blocks = (n + kWarps - 1) / kWarps;
    if (blocks > held) blocks = held;
  }
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
