// Persistent whole-frame path tracer for sphere scenes and meshes of up to
// 16,384 triangles, with their lights, media and textures, one thread per
// lane.
//
// Replaces rtow_tpu/ops/pallas_megakernel.py:_kernel (classic scheduler,
// RTOW_POOL=0) with its shared bounce code (_bounce_core, ported in
// bounce.cuh for K1, K3, K4 and K5).  The plain PyTorch version is
// render_blocks_reference in rtow_tpu_torch/ops/megakernel.py; the wrapper
// is render_blocks.
//
// What bounds it on Hopper: float32 ALU work and warp divergence, not bytes.
// The cover's table is 512 rows x 64 B = 32 KB, read once per block, and a
// bounce moves no lane state through memory: each sweep is ~25 float32
// operations per sphere per ray, and lanes of a warp run paths of different
// lengths.  The design answers that with lane-private state in registers, a
// per-thread loop (a warp retires when its slowest pixel is done, as a TPU
// tile does), and the sphere table served from shared memory as broadcast
// 16-byte loads (every thread of a warp reads the same sphere).  The
// triangle table (up to 16,384 rows x 64 B = 1 MB) does not fit shared
// memory: it stays in global memory, read through the read-only path and
// held in L2, and each thread slab-tests every 128-row block's box and
// sweeps only the blocks its ray enters.  Scenes without triangles run the
// sphere-only instance of the kernel, unchanged.  Two-sided triangles
// (cull = 0) run triangle instances of their own (kTwoSided): the side
// test is then fixed at compile time, where a run-time one cost the lit
// Cornell box 2-3% on an H100 (an AND per triangle test); 6 instances in
// all.
//
// Scenes with lights, textures, media or roulette run the lit instances
// (kLit, bounce_lane_t<kTris, true>): the same loop, the alive code 2
// after a diffuse scatter for the emission's MIS weight, and the light and
// volume rows staged in shared memory behind the sphere table (each lane
// reads the row it picked, so __constant__ would serialise the reads).
// Each lit feature is gated at run time by the scene's Lit; kLit is the
// one template flag, so the sphere-only and triangle instances compile to
// the plain bounce.  The NEE shadow sweep adds a second sphere and triangle
// sweep per diffuse hit, counted in `tests` as the main sweep is, and in
// `shadows`.  What bounds
// the lit instances is again ALU work and divergence: a lane that takes a
// light sample, a volume event or a texture runs a long branch its warp's
// other lanes wait for, and every shadow ray sweeps the tables once more.
// The light and volume rows are read by all lanes, so they sit in shared
// memory; the branches stay per thread (a simple kernel first).
//
// Lane ids, tiles and the counter RNG are the JAX kernel's bit for bit
// (pallas_megakernel.py:1477-1482, :1560-1561, :112-131): lane
// pix = tile * 1024 + row * 128 + col over 8x128-pixel tiles, salt
// mix(seed + it * 40503) with `it` the lane's own step count.  The sweep
// tests every sphere (no block cull; culling never changes the winner) and
// keeps the JAX tie rule: the first minimal t in table order wins.  Stats:
// ray steps, and the triangle sweep's box and triangle tests.
//
// Numbers: float32 throughout with IEEE division and square root, built with
// -fmad=false, so every operation rounds as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce.cuh"

namespace {

constexpr int kTileRows = 8;
constexpr int kLanes = 128;
constexpr int kTile = kTileRows * kLanes;
constexpr int kThreads = 256;

struct Cam {
  float ox, oy, oz, ux, uy, uz, vx, vy, vz, llx, lly, llz;
  float hx, hy, hz, wx, wy, wz, lens_r, t0, dt;
};

// kLit: the lit bounce; lit.rows points at global memory here and is
// staged into shared memory.  kTwoSided: the triangles' side test, fixed at
// compile time (the launcher picks the instance from tris.side_mask).
template <bool kTris, bool kLit, bool kTwoSided>
__global__ void __launch_bounds__(kThreads)
    megakernel(const float4* __restrict__ table, int npad, rtow::Tris tris,
               const float* __restrict__ cam_vec, int seed, int width,
               int height, int tile0, int spp, int max_depth,
               rtow::Background bg, float* __restrict__ out_r,
               float* __restrict__ out_g, float* __restrict__ out_b,
               unsigned long long* __restrict__ steps,
               unsigned long long* __restrict__ tests,
               unsigned long long* __restrict__ shadows, rtow::Lit lit,
               int lit_rows) {
  using rtow::uniform;
  tris.side_mask = kTwoSided ? rtow::kDropSign : rtow::kKeepSign;
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
  const int pid = tile0 + g / kTile;
  const int row = (g % kTile) / kLanes;
  const int col = g % kLanes;
  const int tiles_x = (width + kLanes - 1) / kLanes;
  const int prow = (pid / tiles_x) * kTileRows + row;
  const int pcol = (pid % tiles_x) * kLanes + col;

  // s: ox oy oz dx dy dz tm tpr tpg tpb rr rg rb (the radiance sums
  // rr rg rb run over all of the pixel's samples).
  float s[rtow::kCont] = {0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f,
                          0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  uint32_t it = 0;
  rtow::Tally tally;
  if (prow < height && pcol < width) {
    Cam c;
    c.ox = cam_vec[0]; c.oy = cam_vec[1]; c.oz = cam_vec[2];
    c.ux = cam_vec[3]; c.uy = cam_vec[4]; c.uz = cam_vec[5];
    c.vx = cam_vec[6]; c.vy = cam_vec[7]; c.vz = cam_vec[8];
    c.llx = cam_vec[9]; c.lly = cam_vec[10]; c.llz = cam_vec[11];
    c.hx = cam_vec[12]; c.hy = cam_vec[13]; c.hz = cam_vec[14];
    c.wx = cam_vec[15]; c.wy = cam_vec[16]; c.wz = cam_vec[17];
    c.lens_r = cam_vec[18]; c.t0 = cam_vec[19]; c.dt = cam_vec[20];

    const uint32_t pix = static_cast<uint32_t>(pid * kTile + row * kLanes + col);
    const uint32_t lane = rtow::lane_hash(pix);
    const float inv_w = 1.0f / static_cast<float>(width - 1);
    const float inv_h = 1.0f / static_cast<float>(height - 1);
    const float frow = static_cast<float>(height - 1 - prow);
    const float fcol = static_cast<float>(pcol);

    int code = 0;  // the alive code
    int bounce = 0, started = 0;
    for (; code != 0 || started < spp; ++it) {
      const uint32_t salt = rtow::salt_of(seed, it);
      const bool from_diffuse = code > 1;

      // ---- regeneration: a thin-lens, time-jittered camera ray -------
      if (code == 0) {
        const float su = (fcol + uniform(lane, salt, 0)) * inv_w;
        const float tv = (frow + uniform(lane, salt, 1)) * inv_h;
        const float rad_l = c.lens_r * sqrtf(uniform(lane, salt, 2));
        const float th = rtow::kTwoPi * uniform(lane, salt, 3);
        const float lx = rad_l * cosf(th);
        const float ly = rad_l * sinf(th);
        s[0] = c.ox + lx * c.ux + ly * c.vx;
        s[1] = c.oy + lx * c.uy + ly * c.vy;
        s[2] = c.oz + lx * c.uz + ly * c.vz;
        s[3] = c.llx + su * c.hx + tv * c.wx - s[0];
        s[4] = c.lly + su * c.hy + tv * c.wy - s[1];
        s[5] = c.llz + su * c.hz + tv * c.wz - s[2];
        s[6] = c.t0 + uniform(lane, salt, 4) * c.dt;
        s[7] = s[8] = s[9] = 1.0f;
        bounce = 0;
        ++started;
      }
      // ---- one bounce (bounce.cuh) -----------------------------------
      code = rtow::bounce_lane_t<kTris, kLit>(tbl, npad, tris, s, &bounce,
                                              lane, salt, max_depth, bg,
                                              &tally, lit, from_diffuse);
    }
  }
  out_r[g] = s[10];
  out_g[g] = s[11];
  out_b[g] = s[12];
  if (steps != nullptr) rtow::warp_add(it, steps);  // stats: ray steps
  if (kTris && tests != nullptr) {  // stats: the sweep's box and row tests
    rtow::warp_add(tally.boxes, tests);
    rtow::warp_add(tally.tris, tests + 1);
  }
  if (kLit && shadows != nullptr)  // stats: NEE shadow rays
    rtow::warp_add(tally.shadows, shadows);
}

template <bool kTris, bool kLit, bool kTwoSided>
int launch(const float* table, int npad, const rtow::Tris& tris,
           const float* cam, int seed, int width, int height, int tile0,
           int spp, int max_depth, int n_tiles, const rtow::Background& bg,
           float* out_r, float* out_g, float* out_b,
           unsigned long long* steps, unsigned long long* tests,
           unsigned long long* shadows, const rtow::Lit& lit, int lit_rows,
           cudaStream_t stream) {
  auto kernel = megakernel<kTris, kLit, kTwoSided>;
  const int smem = (npad * rtow::kCols + (kLit ? lit_rows * rtow::kLitCols
                                               : 0)) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = n_tiles * (kTile / kThreads);
  kernel<<<blocks, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(table), npad, tris, cam, seed, width,
      height, tile0, spp, max_depth, bg, out_r, out_g, out_b, steps, tests,
      shadows, lit, lit_rows);
  return static_cast<int>(cudaGetLastError());
}

// The instance for the scene: with or without triangles, lit where the
// scene has any lit feature, two-sided where tris.side_mask says so.
template <bool kTris>
int dispatch(bool any_lit, const float* table, int npad,
             const rtow::Tris& tris, const float* cam, int seed, int width,
             int height, int tile0, int spp, int max_depth, int n_tiles,
             const rtow::Background& bg, float* out_r, float* out_g,
             float* out_b, unsigned long long* steps,
             unsigned long long* tests, unsigned long long* shadows,
             const rtow::Lit& lit, int lit_rows, cudaStream_t stream) {
  const bool two_sided = kTris && tris.side_mask == rtow::kDropSign;
  auto run = any_lit ? launch<kTris, true, false> : launch<kTris, false, false>;
  if (two_sided)
    run = any_lit ? launch<kTris, true, kTris> : launch<kTris, false, kTris>;
  return run(table, npad, tris, cam, seed, width, height, tile0, spp,
             max_depth, n_tiles, bg, out_r, out_g, out_b, steps, tests,
             shadows, lit, lit_rows, stream);
}

}  // namespace

extern "C" {

// Launches the kernel over tiles tile0 .. tile0 + n_tiles - 1 on `stream`.
// table: (npad, 16) float32, 16-byte aligned (npad may be 0); tri: null, or
// (tri_blocks * tri_block, 16) float32 rows with (tri_blocks, 8) block boxes
// tri_boxes, of which the first tri_count rows are triangles; cam: (21,)
// float32; outputs: (n_tiles * 8, 128) float32 each; steps: null, or one
// uint64 that the launch adds its ray steps to; tests: null, or two uint64
// that it adds its box and triangle tests to; shadows: null, or one uint64
// that it adds its NEE shadow rays to.  The lit features: lit_rows,
// the (vol_row0 + n_vol or n_lights) x 14 float32 light then volume rows;
// emissive, checker, roulette flags; n_lights lights of kinds light_kinds
// and n_vol volumes of kinds vol_kinds (2 bits each, row 0 lowest); cull:
// 1 one-sided triangles, 0 two-sided.  Returns the cudaError_t of the
// launch.
int rtow_megakernel(const float* table, int npad, const float* tri,
                    const float* tri_boxes, int tri_blocks, int tri_block,
                    int tri_count, const float* cam, int seed, int width,
                    int height, int tile0, int spp, int max_depth, int n_tiles,
                    int use_sky, float bgr, float bgg, float bgb, float* out_r,
                    float* out_g, float* out_b, unsigned long long* steps,
                    unsigned long long* tests, unsigned long long* shadows,
                    const float* lit_rows,
                    int emissive, int n_lights, int light_kinds, int checker,
                    int n_vol, int vol_kinds, int vol_row0, int roulette,
                    int cull, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rtow::Tris tris{reinterpret_cast<const float4*>(tri),
                        reinterpret_cast<const float4*>(tri_boxes),
                        nullptr, nullptr, tri_blocks, 0, 0, tri_block,
                        tri_count, cull ? rtow::kKeepSign : rtow::kDropSign};
  const rtow::Background bg{use_sky, bgr, bgg, bgb};
  const rtow::Lit lit{lit_rows, emissive, n_lights, checker, n_vol,
                      vol_row0, roulette,
                      static_cast<uint32_t>(light_kinds),
                      static_cast<uint32_t>(vol_kinds)};
  const int rows = n_vol > 0 ? vol_row0 + n_vol : n_lights;
  const bool any_lit =
      emissive || n_lights > 0 || n_vol > 0 || checker || roulette;
  const auto st = static_cast<cudaStream_t>(stream);
  if (tri_blocks > 0)
    return dispatch<true>(any_lit, table, npad, tris, cam, seed, width,
                          height, tile0, spp, max_depth, n_tiles, bg, out_r,
                          out_g, out_b, steps, tests, shadows, lit, rows, st);
  return dispatch<false>(any_lit, table, npad, tris, cam, seed, width, height,
                         tile0, spp, max_depth, n_tiles, bg, out_r, out_g,
                         out_b, steps, tests, shadows, lit, rows, st);
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
