// Persistent whole-frame path tracer for sphere scenes, one thread per lane.
//
// Replaces rtow_tpu/ops/pallas_megakernel.py:_kernel (sphere scenes, classic
// scheduler, RTOW_POOL=0) with the sphere subset of its shared bounce code
// (_bounce_core, ported once in bounce.cuh for K1, K4 and K5).  The plain
// PyTorch version is render_blocks_reference in
// rtow_tpu_torch/ops/megakernel.py; the wrapper is render_blocks.
//
// What bounds it on Hopper: float32 ALU work and warp divergence, not bytes.
// The cover's table is 512 rows x 64 B = 32 KB, read once per block, and a
// bounce moves no lane state through memory: each sweep is ~25 float32
// operations per sphere per ray, and lanes of a warp run paths of different
// lengths.  The design answers that with lane-private state in registers, a
// per-thread loop (a warp retires when its slowest pixel is done, as a TPU
// tile does), and the table served from shared memory as broadcast 16-byte
// loads (every thread of a warp reads the same sphere).
//
// Lane ids, tiles and the counter RNG are the JAX kernel's bit for bit
// (pallas_megakernel.py:1477-1482, :1560-1561, :112-131): lane
// pix = tile * 1024 + row * 128 + col over 8x128-pixel tiles, salt
// mix(seed + it * 40503) with `it` the lane's own step count.  The sweep
// tests every sphere (no block cull; culling never changes the winner) and
// keeps the JAX tie rule: the first minimal t in table order wins.
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

__global__ void __launch_bounds__(kThreads)
    megakernel(const float4* __restrict__ table, int npad,
               const float* __restrict__ cam_vec, int seed, int width,
               int height, int tile0, int spp, int max_depth,
               rtow::Background bg, float* __restrict__ out_r,
               float* __restrict__ out_g, float* __restrict__ out_b,
               unsigned long long* __restrict__ steps) {
  using rtow::uniform;
  extern __shared__ float4 tbl[];  // npad rows x 4 float4
  for (int i = threadIdx.x; i < npad * 4; i += blockDim.x) tbl[i] = table[i];
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

    bool alive = false;
    int bounce = 0, started = 0;
    for (; alive || started < spp; ++it) {
      const uint32_t salt = rtow::salt_of(seed, it);

      // ---- regeneration: a thin-lens, time-jittered camera ray -------
      if (!alive) {
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
      alive = rtow::bounce_lane(tbl, npad, s, &bounce, lane, salt, max_depth,
                                bg);
    }
  }
  out_r[g] = s[10];
  out_g[g] = s[11];
  out_b[g] = s[12];
  if (steps != nullptr) {  // stats: ray steps (bounces) of this launch
    unsigned long long n = it;
    for (int off = 16; off > 0; off >>= 1)
      n += __shfl_down_sync(0xFFFFFFFFu, n, off);
    if ((threadIdx.x & 31) == 0) atomicAdd(steps, n);
  }
}

}  // namespace

extern "C" {

// Launches the kernel over tiles tile0 .. tile0 + n_tiles - 1 on `stream`.
// table: (npad, 16) float32, 16-byte aligned; cam: (21,) float32; outputs:
// (n_tiles * 8, 128) float32 each; steps: null, or one uint64 that the
// launch adds its ray steps to.  Returns the cudaError_t of the launch.
int rtow_megakernel(const float* table, int npad, const float* cam, int seed,
                    int width, int height, int tile0, int spp, int max_depth,
                    int n_tiles, int use_sky, float bgr, float bgg, float bgb,
                    float* out_r, float* out_g, float* out_b,
                    unsigned long long* steps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = npad * rtow::kCols * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(megakernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = n_tiles * (kTile / kThreads);
  megakernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), npad, cam, seed, width, height,
      tile0, spp, max_depth, rtow::Background{use_sky, bgr, bgg, bgb}, out_r,
      out_g, out_b, steps);
  return static_cast<int>(cudaGetLastError());
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
