// Persistent whole-frame path tracer for sphere scenes and meshes of up to
// 16,384 triangles, with their lights, media and textures, one thread per
// lane.
//
// Replaces rtow_tpu/ops/pallas_megakernel.py:_kernel, both schedulers
// (classic, RTOW_POOL=0; the drain-balanced work pool, RTOW_POOL=1,
// :1492-1615 and :1689-1726), with its shared bounce code (_bounce_core,
// ported in bounce.cuh for K1, K3, K4 and K5).  The plain PyTorch version
// is render_blocks_reference in rtow_tpu_torch/ops/megakernel.py; the
// wrapper is render_blocks.
//
// What bounds it on Hopper: float32 ALU work and warp divergence, not bytes.
// The cover's table is 512 rows x 64 B = 32 KB, read once per block, and a
// bounce moves no lane state through memory: each sweep is ~25 float32
// operations per sphere row tested per ray (built with -fmad=false, each
// multiply and add its own instruction), and lanes of a warp run paths of
// different lengths.  The design answers that with lane-private state in
// registers, a per-thread loop (a warp retires when its slowest pixel is
// done, as a TPU tile does), and the sphere table served from shared memory
// as broadcast 16-byte loads.  Since the instructions run near their
// ceiling, the sweep tests fewer rows: each thread slab-tests the boxes of
// the table's Morton-ordered row groups (SphereGroups, kSphereGroup = 16
// rows each, the boxes read from global memory through the read-only
// cache; the JAX kernel culls 128-row blocks per tile, _sweep_all :390)
// and sweeps only the groups its ray enters before its current best t (the
// shadow sweep's threshold), so the winner is the brute-force sweep's, bit
// for bit.  The
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
// The work pool (kPool instances, the JAX package's production
// scheduler).  A classic lane owns one pixel, so its warp runs until the
// warp's hardest pixel has all its samples.  Under the pool each image
// row's 128 pixels x spp samples form a queue of (column, chunk-sample)
// items: item i is column i % 128, chunk i / 128.  Lane c starts on item c;
// every K iterations the row's idle lanes (dead, no samples left) meet at
// a barrier and take the next items in lane order, an exclusive prefix sum
// (a warp ballot and popc, then the four warps' counts in shared memory).
// Before it switches columns a taking lane flushes its radiance: the lanes
// stage (column, radiance) in shared memory, and the thread of column c
// adds the taking lanes at c in lane order to a sum held in its registers,
// the order the plain version sums in, so kernel and plain version agree
// bit for bit.  Between barriers every thread runs its K iterations on its
// own.  A 256-thread block holds two rows; both iterate together (one
// __syncthreads_or decides whether either row still has work), and a row
// with nothing left runs empty iterations, which change nothing.  `it` is
// then the row's iteration count, which idle lanes advance too, as in the
// JAX kernel.  The pool adds 4 KB of shared memory per block (PoolStage)
// and fixes the scheduler at compile time: the classic instances are the
// classic loop alone, as before.
//
// Lane ids, tiles and the counter RNG are the JAX kernel's bit for bit
// (pallas_megakernel.py:1477-1482, :1560-1561, :112-131): lane
// pix = tile * 1024 + row * 128 + col over 8x128-pixel tiles, salt
// mix(seed + it * 40503) with `it` the lane's own step count (classic) or
// the row's iteration count (pool).  The sweep
// keeps the JAX tie rule: the first minimal t in table order wins.  Stats:
// ray steps (live lane-iterations), lane slots (32 x each warp's longest
// loop under the classic scheduler, 128 x each row's iterations under the
// pool: steps / slots is the occupancy), the sphere groups' box tests and
// rows swept, and the triangle sweep's box and triangle tests.
//
// The ticker (pipeline.render_megakernel(progress=True)): one whole-frame
// launch, each block adding its two finished tile rows to a counter in
// mapped, pinned host memory (a system-scope atomic after
// __threadfence_system) that the host polls while the launch runs.
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
// Every instance sweeps the spheres group by group.
constexpr auto kCull = rtow::SphereCull::kGroups;

struct Cam {
  float ox, oy, oz, ux, uy, uz, vx, vy, vz, llx, lly, llz;
  float hx, hy, hz, wx, wy, wz, lens_r, t0, dt;
};

struct Pool {
  int chunk, k;  // samples per item, iterations between hand-outs
};

// The pool's shared staging for a block's two rows: each lane's column and
// radiance, and per warp its take mask and its count of idle lanes.
struct PoolStage {
  int col[kThreads];
  float r[kThreads], g[kThreads], b[kThreads];
  unsigned mask[kThreads / 32];
  int count[kThreads / 32];
};

// Adds to acc the radiance of the staged lanes of row rb whose mask bit is
// set and whose column is `col`, summed in lane order from 0.
__device__ __forceinline__ void pool_flush(float* acc, const PoolStage& st,
                                           int rb, int col) {
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
  for (int w = rb * 4; w < rb * 4 + 4; ++w) {
    for (unsigned m = st.mask[w]; m != 0; m &= m - 1) {
      const int i = w * 32 + __ffs(m) - 1;
      if (st.col[i] == col) {
        sr += st.r[i];
        sg += st.g[i];
        sb += st.b[i];
      }
    }
  }
  acc[0] += sr;
  acc[1] += sg;
  acc[2] += sb;
}

__device__ __forceinline__ Cam load_cam(const float* v) {
  return Cam{v[0],  v[1],  v[2],  v[3],  v[4],  v[5],  v[6],
             v[7],  v[8],  v[9],  v[10], v[11], v[12], v[13],
             v[14], v[15], v[16], v[17], v[18], v[19], v[20]};
}

// A thin-lens, time-jittered camera ray through pixel column fcol and
// flipped row frow into s (origin, direction, time; throughput 1).
__device__ __forceinline__ void camera_ray(const Cam& c, uint32_t lane,
                                           uint32_t salt, float fcol,
                                           float frow, float inv_w,
                                           float inv_h, float* s) {
  using rtow::uniform;
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
}

// kLit: the lit bounce; lit.rows points at global memory here and is
// staged into shared memory.  kTwoSided: the triangles' side test, fixed at
// compile time (the launcher picks the instance from tris.side_mask).
// kPool: the work pool's scheduler, else the classic one.
template <bool kTris, bool kLit, bool kTwoSided, bool kPool>
__global__ void __launch_bounds__(kThreads)
    megakernel(const float4* __restrict__ table, int npad,
               rtow::SphereGroups sg, rtow::Tris tris,
               const float* __restrict__ cam_vec, int seed, int width,
               int height, int tile0, int spp, int max_depth,
               rtow::Background bg, float* __restrict__ out_r,
               float* __restrict__ out_g, float* __restrict__ out_b,
               unsigned long long* __restrict__ steps,
               unsigned long long* __restrict__ tests,
               unsigned long long* __restrict__ shadows,
               unsigned long long* __restrict__ spheres, rtow::Lit lit,
               int lit_rows, Pool P, unsigned long long* __restrict__ slots,
               unsigned int* progress) {
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
  const uint32_t lane =
      rtow::lane_hash(static_cast<uint32_t>(pid * kTile + row * kLanes + col));
  const float inv_w = 1.0f / static_cast<float>(width - 1);
  const float inv_h = 1.0f / static_cast<float>(height - 1);
  const float frow = static_cast<float>(height - 1 - prow);

  // s: ox oy oz dx dy dz tm tpr tpg tpb rr rg rb (the radiance sums
  // rr rg rb run over all of the lane's samples since its last flush).
  float s[rtow::kCont] = {0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f,
                          0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  uint32_t it = 0;
  unsigned long long n_steps = 0;
  rtow::Tally tally;
  int code = 0;  // the alive code
  int bounce = 0;
  if constexpr (!kPool) {
    if (prow < height && pcol < width) {
      const Cam c = load_cam(cam_vec);
      const float fcol = static_cast<float>(pcol);
      int started = 0;
      for (; code != 0 || started < spp; ++it) {
        const uint32_t salt = rtow::salt_of(seed, it);
        const bool from_diffuse = code > 1;
        // ---- regeneration: a thin-lens, time-jittered camera ray -------
        if (code == 0) {
          camera_ray(c, lane, salt, fcol, frow, inv_w, inv_h, s);
          bounce = 0;
          ++started;
        }
        // ---- one bounce (bounce.cuh) -----------------------------------
        code = rtow::bounce_lane_t<kTris, kLit, rtow::Sweep::kThread,
                                   kCull>(tbl, npad, tris, s, &bounce, lane,
                                          salt, max_depth, bg, &tally, lit,
                                          from_diffuse, sg);
      }
    }
    n_steps = it;
    out_r[g] = s[10];
    out_g[g] = s[11];
    out_b[g] = s[12];
    if (slots != nullptr) {  // stats: 32 x the warp's longest loop
      const unsigned longest = __reduce_max_sync(0xFFFFFFFFu, it);
      if ((threadIdx.x & 31) == 0) atomicAdd(slots, 32ull * longest);
    }
  } else {
    __shared__ PoolStage st;
    const Cam c = load_cam(cam_vec);
    const int rb = threadIdx.x / kLanes;  // the block's row: 0 or 1
    const int warp = threadIdx.x / 32;
    const int wl = threadIdx.x & 31;
    const int pcol0 = pcol - col;
    const bool row_ok = prow < height;
    const int n_items = (spp + P.chunk - 1) / P.chunk * kLanes;
    // Samples of item (column cc, chunk ch): none off the image.
    auto budget = [&](int cc, int ch) {
      const int left = min(max(spp - ch * P.chunk, 0), P.chunk);
      return row_ok && pcol0 + cc < width ? left : 0;
    };
    int rem = budget(col, 0);  // samples left in the lane's item
    int cur = col;             // the lane's current column
    int nxt = kLanes;          // the row's next item
    float acc[3] = {0.0f, 0.0f, 0.0f};  // column col's pixel sums
    uint32_t last_live = 0;  // 1 + the last iteration this lane stepped
    uint32_t open_end = 0;   // 1 + the last hand-out with items left
    for (;;) {
      // ---- hand-out at it % K == 0: both rows' lanes meet here ---------
      const bool go = code != 0 || rem > 0 || nxt < n_items;
      if (!__syncthreads_or(go)) break;
      if (nxt < n_items) open_end = it + 1;
      const bool done = code == 0 && rem == 0;
      const unsigned dm = __ballot_sync(0xFFFFFFFFu, done);
      if (wl == 0) st.count[warp] = __popc(dm);
      __syncthreads();
      int off = __popc(dm & ((1u << wl) - 1u)), idle = 0;
      for (int w = rb * 4; w < rb * 4 + 4; ++w) {
        off += w < warp ? st.count[w] : 0;
        idle += st.count[w];
      }
      const int item = nxt + off;
      const bool take = done && item < n_items;
      const unsigned tm = __ballot_sync(0xFFFFFFFFu, take);
      st.col[threadIdx.x] = cur;
      st.r[threadIdx.x] = s[10];
      st.g[threadIdx.x] = s[11];
      st.b[threadIdx.x] = s[12];
      if (wl == 0) st.mask[warp] = tm;
      __syncthreads();
      pool_flush(acc, st, rb, col);
      if (take) {
        s[10] = s[11] = s[12] = 0.0f;
        cur = item % kLanes;
        rem = budget(cur, item / kLanes);
      }
      nxt += min(idle, max(n_items - nxt, 0));
      // ---- K iterations, each lane on its own --------------------------
      for (int j = 0; j < P.k; ++j, ++it) {
        const uint32_t salt = rtow::salt_of(seed, it);
        const bool from_diffuse = code > 1;
        const bool need = code == 0 && rem > 0;
        if (need) {
          camera_ray(c, lane, salt, static_cast<float>(pcol0 + cur), frow,
                     inv_w, inv_h, s);
          bounce = 0;
          --rem;
        }
        if (code != 0 || need) {
          code = rtow::bounce_lane_t<kTris, kLit, rtow::Sweep::kThread,
                                     kCull>(tbl, npad, tris, s, &bounce,
                                            lane, salt, max_depth, bg,
                                            &tally, lit, from_diffuse, sg);
          ++n_steps;
          last_live = it + 1;
        }
      }
    }
    // ---- final flush: every lane's radiance joins its column -----------
    st.col[threadIdx.x] = cur;
    st.r[threadIdx.x] = s[10];
    st.g[threadIdx.x] = s[11];
    st.b[threadIdx.x] = s[12];
    if (wl == 0) st.mask[warp] = 0xFFFFFFFFu;
    const unsigned longest = __reduce_max_sync(0xFFFFFFFFu, last_live);
    if (wl == 0) st.count[warp] = static_cast<int>(longest);
    __syncthreads();
    pool_flush(acc, st, rb, col);
    out_r[g] = acc[0];
    out_g[g] = acc[1];
    out_b[g] = acc[2];
    // stats: 128 x the row's iterations, the iterations the JAX kernel's
    // loop condition runs it for: until its lanes are done and its queue
    // is drained.
    if (slots != nullptr && col == 0) {
      uint32_t n_it = open_end;
      for (int w = rb * 4; w < rb * 4 + 4; ++w)
        n_it = max(n_it, static_cast<uint32_t>(st.count[w]));
      atomicAdd(slots, static_cast<unsigned long long>(kLanes) * n_it);
    }
  }
  if (steps != nullptr) rtow::warp_add(n_steps, steps);  // stats: ray steps
  if (kTris && tests != nullptr) {  // stats: the sweep's box and row tests
    rtow::warp_add(tally.boxes, tests);
    rtow::warp_add(tally.tris, tests + 1);
  }
  if (kLit && shadows != nullptr)  // stats: NEE shadow rays
    rtow::warp_add(tally.shadows, shadows);
  if (spheres != nullptr) {  // stats: the sphere groups' box and row tests
    rtow::warp_add(tally.sph_boxes, spheres);
    rtow::warp_add(tally.sph_rows, spheres + 1);
  }
  if (progress != nullptr) {  // the ticker: the block's two rows are done
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence_system();
      atomicAdd_system(progress, kThreads / kLanes);
    }
  }
}

template <bool kTris, bool kLit, bool kTwoSided, bool kPool>
int launch(const float* table, int npad, const rtow::SphereGroups& sg,
           const rtow::Tris& tris, const float* cam, int seed, int width,
           int height, int tile0, int spp, int max_depth, int n_tiles,
           const rtow::Background& bg, float* out_r, float* out_g,
           float* out_b, unsigned long long* steps, unsigned long long* tests,
           unsigned long long* shadows, unsigned long long* spheres,
           const rtow::Lit& lit, int lit_rows, const Pool& pool,
           unsigned long long* slots, unsigned int* progress,
           cudaStream_t stream) {
  auto kernel = megakernel<kTris, kLit, kTwoSided, kPool>;
  const int smem = (npad * rtow::kCols + (kLit ? lit_rows * rtow::kLitCols
                                               : 0)) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = n_tiles * (kTile / kThreads);
  kernel<<<blocks, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(table), npad, sg, tris, cam, seed,
      width, height, tile0, spp, max_depth, bg, out_r, out_g, out_b, steps,
      tests, shadows, spheres, lit, lit_rows, pool, slots, progress);
  return static_cast<int>(cudaGetLastError());
}

// The instance for the scene: with or without triangles, lit where the
// scene has any lit feature, two-sided where tris.side_mask says so, the
// pool's scheduler where pool.k > 0.
template <bool kTris, bool kPool>
int dispatch(bool any_lit, const float* table, int npad,
             const rtow::SphereGroups& sg, const rtow::Tris& tris,
             const float* cam, int seed, int width, int height, int tile0,
             int spp, int max_depth, int n_tiles, const rtow::Background& bg,
             float* out_r, float* out_g, float* out_b,
             unsigned long long* steps, unsigned long long* tests,
             unsigned long long* shadows, unsigned long long* spheres,
             const rtow::Lit& lit, int lit_rows, const Pool& pool,
             unsigned long long* slots, unsigned int* progress,
             cudaStream_t stream) {
  const bool two_sided = kTris && tris.side_mask == rtow::kDropSign;
  auto run = any_lit ? launch<kTris, true, false, kPool>
                     : launch<kTris, false, false, kPool>;
  if (two_sided)
    run = any_lit ? launch<kTris, true, kTris, kPool>
                  : launch<kTris, false, kTris, kPool>;
  return run(table, npad, sg, tris, cam, seed, width, height, tile0, spp,
             max_depth, n_tiles, bg, out_r, out_g, out_b, steps, tests,
             shadows, spheres, lit, lit_rows, pool, slots, progress, stream);
}

}  // namespace

extern "C" {

// Launches the kernel over tiles tile0 .. tile0 + n_tiles - 1 on `stream`.
// table: (npad, 16) float32, 16-byte aligned (npad may be 0); sph_boxes:
// (n_groups, 8) float32 boxes of the table's groups of kSphereGroup rows
// (n_groups * kSphereGroup = npad); tri: null, or
// (tri_blocks * tri_block, 16) float32 rows with (tri_blocks, 8) block boxes
// tri_boxes, of which the first tri_count rows are triangles; cam: (21,)
// float32; outputs: (n_tiles * 8, 128) float32 each; steps: null, or one
// uint64 that the launch adds its ray steps to; tests: null, or two uint64
// that it adds its box and triangle tests to; shadows: null, or one uint64
// that it adds its NEE shadow rays to; spheres: null, or two uint64 that it
// adds its sphere-group box tests and sphere rows swept to.  The lit
// features: lit_rows,
// the (vol_row0 + n_vol or n_lights) x 14 float32 light then volume rows;
// emissive, checker, roulette flags; n_lights lights of kinds light_kinds
// and n_vol volumes of kinds vol_kinds (2 bits each, row 0 lowest); cull:
// 1 one-sided triangles, 0 two-sided.  pool: 1 the work pool with items
// of pool_chunk samples handed out every pool_k iterations, 0 the classic
// scheduler; slots: null, or one uint64 that the launch adds its lane
// slots to; progress: null, or a device pointer to one uint32 (mapped host
// memory from rtow_progress_alloc) that each block adds its two finished
// tile rows to.  Returns the cudaError_t of the launch.
int rtow_megakernel(const float* table, int npad, const float* sph_boxes,
                    int n_groups, const float* tri,
                    const float* tri_boxes, int tri_blocks, int tri_block,
                    int tri_count, const float* cam, int seed, int width,
                    int height, int tile0, int spp, int max_depth, int n_tiles,
                    int use_sky, float bgr, float bgg, float bgb, float* out_r,
                    float* out_g, float* out_b, unsigned long long* steps,
                    unsigned long long* tests, unsigned long long* shadows,
                    unsigned long long* spheres, const float* lit_rows,
                    int emissive, int n_lights, int light_kinds, int checker,
                    int n_vol, int vol_kinds, int vol_row0, int roulette,
                    int cull, int pool, int pool_chunk, int pool_k,
                    unsigned long long* slots, unsigned int* progress,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pool && (pool_chunk < 1 || pool_k < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups * rtow::kSphereGroup != npad)
    return static_cast<int>(cudaErrorInvalidValue);
  const rtow::SphereGroups sg{reinterpret_cast<const float4*>(sph_boxes),
                              n_groups};
  const rtow::Tris tris{reinterpret_cast<const float4*>(tri),
                        reinterpret_cast<const float4*>(tri_boxes),
                        nullptr, nullptr, tri_blocks, 0, 0, tri_block,
                        tri_count, cull ? rtow::kKeepSign : rtow::kDropSign};
  const rtow::Background bg{use_sky, bgr, bgg, bgb};
  const rtow::Lit lit{lit_rows, emissive, n_lights, checker, n_vol,
                      vol_row0, roulette,
                      static_cast<uint32_t>(light_kinds),
                      static_cast<uint32_t>(vol_kinds)};
  const Pool P{pool_chunk, pool_k};
  const int rows = n_vol > 0 ? vol_row0 + n_vol : n_lights;
  const bool any_lit =
      emissive || n_lights > 0 || n_vol > 0 || checker || roulette;
  const auto st = static_cast<cudaStream_t>(stream);
  auto run = tri_blocks > 0 ? (pool ? dispatch<true, true>
                                    : dispatch<true, false>)
                            : (pool ? dispatch<false, true>
                                    : dispatch<false, false>);
  return run(any_lit, table, npad, sg, tris, cam, seed, width, height, tile0,
             spp, max_depth, n_tiles, bg, out_r, out_g, out_b, steps, tests,
             shadows, spheres, lit, rows, P, slots, progress, st);
}

// One uint32 of mapped, pinned host memory for the ticker's counter:
// *host is its host address, *dev the address the kernel adds to.
// Returns the cudaError_t of the allocation.
int rtow_progress_alloc(int device, unsigned int** host, unsigned int** dev) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaHostAlloc(reinterpret_cast<void**>(host), sizeof(unsigned int),
                        cudaHostAllocMapped);
  if (err == cudaSuccess) {
    **host = 0u;
    err = cudaHostGetDevicePointer(reinterpret_cast<void**>(dev), *host, 0);
  }
  return static_cast<int>(err);
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
