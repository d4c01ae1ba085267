// Persistent whole-frame path tracer for sphere scenes, one thread per lane.
//
// Replaces rtow_tpu/ops/pallas_megakernel.py:_kernel (sphere scenes, classic
// scheduler, RTOW_POOL=0) with the sphere subset of its shared bounce code
// (_bounce_core: _sweep_all, _hit_basics, _shade_pure, _draw_scatter).  The
// plain PyTorch version is render_blocks_reference in
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

namespace {

constexpr int kTileRows = 8;
constexpr int kLanes = 128;
constexpr int kTile = kTileRows * kLanes;
constexpr int kCols = 16;  // floats per table row = 4 float4
constexpr int kThreads = 256;

constexpr float kTMin = 1e-3f;
constexpr float kBig = 3.0e38f;
constexpr float kInv24 = 1.0f / 16777216.0f;
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kEps12 = 1e-12f;
constexpr uint32_t kGolden = 0x9E3779B9u;

// Table columns: c0x c0y c0z dcx | dcy dcz r alr | alg alb fuzz ir | kind ...
constexpr float kMetal = 1.0f;
constexpr float kDielectric = 2.0f;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform(uint32_t lane, uint32_t salt,
                                         uint32_t draw) {
  const uint32_t h = mix(lane ^ (salt + draw * kGolden));
  return static_cast<float>(static_cast<int>(h >> 8)) * kInv24;
}

struct Cam {
  float ox, oy, oz, ux, uy, uz, vx, vy, vz, llx, lly, llz;
  float hx, hy, hz, wx, wy, wz, lens_r, t0, dt;
};

__global__ void __launch_bounds__(kThreads)
    megakernel(const float4* __restrict__ table, int npad,
               const float* __restrict__ cam_vec, int seed, int width,
               int height, int tile0, int spp, int max_depth, int use_sky,
               float bgr, float bgg, float bgb, float* __restrict__ out_r,
               float* __restrict__ out_g, float* __restrict__ out_b) {
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

  float rr = 0.0f, rg = 0.0f, rb = 0.0f;
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
    const uint32_t lane = mix(pix * kGolden);
    const float inv_w = 1.0f / static_cast<float>(width - 1);
    const float inv_h = 1.0f / static_cast<float>(height - 1);
    const float frow = static_cast<float>(height - 1 - prow);
    const float fcol = static_cast<float>(pcol);

    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 0.0f, dz = 0.0f;
    float tm = 0.0f, tpr = 0.0f, tpg = 0.0f, tpb = 0.0f;
    bool alive = false;
    int bounce = 0, started = 0;

    for (uint32_t it = 0; alive || started < spp; ++it) {
      const uint32_t salt = mix(static_cast<uint32_t>(seed) + it * 40503u);

      // ---- regeneration: a thin-lens, time-jittered camera ray -------
      if (!alive) {
        const float s = (fcol + uniform(lane, salt, 0)) * inv_w;
        const float t = (frow + uniform(lane, salt, 1)) * inv_h;
        const float rad_l = c.lens_r * sqrtf(uniform(lane, salt, 2));
        const float th = kTwoPi * uniform(lane, salt, 3);
        const float lx = rad_l * cosf(th);
        const float ly = rad_l * sinf(th);
        ox = c.ox + lx * c.ux + ly * c.vx;
        oy = c.oy + lx * c.uy + ly * c.vy;
        oz = c.oz + lx * c.uz + ly * c.vz;
        dx = c.llx + s * c.hx + t * c.wx - ox;
        dy = c.lly + s * c.hy + t * c.wy - oy;
        dz = c.llz + s * c.hz + t * c.wz - oz;
        tm = c.t0 + uniform(lane, salt, 4) * c.dt;
        tpr = tpg = tpb = 1.0f;
        bounce = 0;
        ++started;
        alive = true;
      }

      // ---- nearest hit over every sphere -----------------------------
      const float a = dx * dx + dy * dy + dz * dz;
      const float inv_a = 1.0f / a;
      float best_t = kBig;
      int best_k = 0;
      for (int k = 0; k < npad; ++k) {
        const float4 p0 = tbl[4 * k];
        const float4 p1 = tbl[4 * k + 1];
        const float ocx = ox - (p0.x + tm * p0.w);
        const float ocy = oy - (p0.y + tm * p1.x);
        const float ocz = oz - (p0.z + tm * p1.y);
        const float h = ocx * dx + ocy * dy + ocz * dz;
        const float cc = ocx * ocx + ocy * ocy + ocz * ocz - p1.z * p1.z;
        const float disc = h * h - a * cc;
        if (disc > 0.0f) {
          const float sq = sqrtf(disc);
          const float near = (-h - sq) * inv_a;
          const float v = near >= kTMin ? near : (-h + sq) * inv_a;
          if (v >= kTMin && v < best_t) {
            best_t = v;
            best_k = k;
          }
        }
      }

      if (!(best_t < kBig)) {  // miss: the sky or the flat background
        float skyr = bgr, skyg = bgg, skyb = bgb;
        if (use_sky) {
          const float sky_t = 0.5f * (dy * (1.0f / sqrtf(a)) + 1.0f);
          skyr = 1.0f - sky_t + sky_t * 0.5f;
          skyg = 1.0f - sky_t + sky_t * 0.7f;
          skyb = 1.0f;
        }
        rr = rr + tpr * skyr;
        rg = rg + tpg * skyg;
        rb = rb + tpb * skyb;
        alive = false;
        continue;
      }
      if (bounce >= max_depth) {  // depth is checked after the hit
        alive = false;
        continue;
      }

      // ---- hit record: t re-derived from the winner's parameters -----
      const float4 q0 = tbl[4 * best_k];
      const float4 q1 = tbl[4 * best_k + 1];
      const float4 q2 = tbl[4 * best_k + 2];
      const float4 q3 = tbl[4 * best_k + 3];
      const float cx = q0.x + tm * q0.w;
      const float cy = q0.y + tm * q1.x;
      const float cz = q0.z + tm * q1.y;
      const float r = q1.z;
      float nx, ny, nz;
      bool front;
      float px, py, pz;
      {
        const float ocx = ox - cx;
        const float ocy = oy - cy;
        const float ocz = oz - cz;
        const float h = ocx * dx + ocy * dy + ocz * dz;
        const float cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
        const float disc = h * h - a * cc;
        const float sq = sqrtf(disc > 0.0f ? disc : 1.0f);
        const float near = (-h - sq) * inv_a;
        const float far = (-h + sq) * inv_a;
        const float t_hit =
            fabsf(near - best_t) <= fabsf(far - best_t) ? near : far;
        px = ox + t_hit * dx;
        py = oy + t_hit * dy;
        pz = oz + t_hit * dz;
        const float r_abs = r == 0.0f ? 1.0f : fabsf(r);
        nx = (px - cx) / r_abs;
        ny = (py - cy) / r_abs;
        nz = (pz - cz) / r_abs;
        front = (dx * nx + dy * ny + dz * nz < 0.0f) != (r < 0.0f);
        const float flip = front ? 1.0f : -1.0f;
        nx = nx * flip;
        ny = ny * flip;
        nz = nz * flip;
      }

      // ---- scatter draws (_draw_scatter) ---------------------------
      const float uz = 1.0f - 2.0f * uniform(lane, salt, 5);
      const float uu = uniform(lane, salt, 6);
      const float one_m = 1.0f - uz * uz;
      const float uxy = sqrtf(one_m > 0.0f ? one_m : 0.0f);
      const float uph = kTwoPi * uu;
      const float uvx = uxy * cosf(uph);
      const float uvy = uxy * sinf(uph);
      const float uvz = uz;

      const float kind = q3.x;
      const float fuzz = q2.z;
      float sdx, sdy, sdz, atr, atg, atb;
      if (kind == kMetal) {  // reflect(raw d) + fuzz * unit
        const float ddn2 = 2.0f * (dx * nx + dy * ny + dz * nz);
        sdx = dx - ddn2 * nx + fuzz * uvx;
        sdy = dy - ddn2 * ny + fuzz * uvy;
        sdz = dz - ddn2 * nz + fuzz * uvz;
        atr = q1.w; atg = q2.x; atb = q2.y;
      } else if (kind == kDielectric) {  // Schlick + TIR, + fuzz
        const float choice = uniform(lane, salt, 7);
        const float inv_dlen = 1.0f / sqrtf(a);
        const float udx = dx * inv_dlen;
        const float udy = dy * inv_dlen;
        const float udz = dz * inv_dlen;
        const float cos_raw = -(udx * nx + udy * ny + udz * nz);
        const float cos_t = cos_raw > 1.0f ? 1.0f : cos_raw;
        const float s2 = 1.0f - cos_t * cos_t;
        const float sin_t = sqrtf(s2 < kEps12 ? kEps12 : s2);
        const float ir = q2.w;
        const float ir_safe = ir > 0.0f ? ir : 1.0f;
        const float ratio = front ? 1.0f / ir_safe : ir_safe;
        const bool cannot = ratio * sin_t > 1.0f;
        float r0 = (1.0f - ratio) / (1.0f + ratio);
        r0 = r0 * r0;
        const float omc = 1.0f - cos_t;
        const float omc2 = omc * omc;
        const float refl_p = r0 + (1.0f - r0) * omc2 * omc2 * omc;
        if (cannot || refl_p > choice) {
          const float udn2 = 2.0f * (udx * nx + udy * ny + udz * nz);
          sdx = udx - udn2 * nx;
          sdy = udy - udn2 * ny;
          sdz = udz - udn2 * nz;
        } else {
          const float k_raw = 1.0f - ratio * ratio * (1.0f - cos_t * cos_t);
          const float sqk = k_raw > 0.0f ? sqrtf(k_raw) : 0.0f;
          sdx = ratio * udx + (ratio * cos_t - sqk) * nx;
          sdy = ratio * udy + (ratio * cos_t - sqk) * ny;
          sdz = ratio * udz + (ratio * cos_t - sqk) * nz;
        }
        sdx = sdx + fuzz * uvx;
        sdy = sdy + fuzz * uvy;
        sdz = sdz + fuzz * uvz;
        atr = atg = atb = 1.0f;
      } else {  // Lambertian: n + unit (degenerate -> n)
        sdx = nx + uvx;
        sdy = ny + uvy;
        sdz = nz + uvz;
        if (sdx * sdx + sdy * sdy + sdz * sdz < kEps12) {
          sdx = nx;
          sdy = ny;
          sdz = nz;
        }
        atr = q1.w; atg = q2.x; atb = q2.y;
      }

      ox = px; oy = py; oz = pz;
      dx = sdx; dy = sdy; dz = sdz;
      tpr = tpr * atr;
      tpg = tpg * atg;
      tpb = tpb * atb;
      ++bounce;
    }
  }
  out_r[g] = rr;
  out_g[g] = rg;
  out_b[g] = rb;
}

}  // namespace

extern "C" {

// Launches the kernel over tiles tile0 .. tile0 + n_tiles - 1 on `stream`.
// table: (npad, 16) float32, 16-byte aligned; cam: (21,) float32; outputs:
// (n_tiles * 8, 128) float32 each.  Returns the cudaError_t of the launch.
int rtow_megakernel(const float* table, int npad, const float* cam, int seed,
                    int width, int height, int tile0, int spp, int max_depth,
                    int n_tiles, int use_sky, float bgr, float bgg, float bgb,
                    float* out_r, float* out_g, float* out_b, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = npad * kCols * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(megakernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = n_tiles * (kTile / kThreads);
  megakernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), npad, cam, seed, width, height,
      tile0, spp, max_depth, use_sky, bgr, bgg, bgb, out_r, out_g, out_b);
  return static_cast<int>(cudaGetLastError());
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
