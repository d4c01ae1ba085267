// The sphere-sweep probe T1: the sweep's pair quadratic on the CUDA cores
// and as matrix products on the tensor cores.
//
// Replaces tools/mxu_probe.py:_build (its four kinds in one pallas_call:
// _vpu_kernel for "vpu" and "mxu_f", _mxu_kernel for "mxu" and "mxu_b").
// The plain PyTorch version is probe_reference in
// rtow_tpu_torch/tools/mxu_probe.py; the wrapper is probe.
//
// Every lane sweeps n_blocks blocks of 128 moving spheres `iters` times: per
// block the first minimal t, taken where it is strictly below the best so
// far, and the winner's 13 parameters; each iteration adds
// t_ok + c0x / 4 + dcx / 2 + r of the winner to the lane's output.
//
// probe_vpu: one thread per lane, the whole table in shared memory (every
// thread of a warp reads the same sphere: a broadcast), the pair quadratic
// in float32 on the CUDA cores.  What bounds it: float32 operations, ~35 a
// pair.  kMxuFetch ("mxu_f") fetches the winner as a one-hot x block
// product on the tensor cores, a warp at a time: A the block's parameters
// (16 x 128 spheres), B the one-hot of the 32 lanes' winners.
//
// probe_mxu: the h and c terms of every (sphere, lane) pair as the product
// of the block's (256, 16) weights with the lanes' (16, 32) features, per
// warp on the tensor cores, then the quadratic, the min and the argmin on
// the CUDA cores straight from the accumulator fragments (the min over a
// 16-sphere tile by two compares and three shuffles), and the fetch as a
// product as above.  kRows lanes rows per CTA: 1 ("mxu", one row of 128
// lanes), 8 ("mxu_b", the 8-row tile of the batched dot_general); the
// block's weights and table rows are staged in shared memory once per CTA.
// What bounds it: the tensor cores' TF32 work (3 passes) and the CUDA-core
// quadratic, ~16 operations a pair.
//
// Precision.HIGHEST becomes 3xTF32: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi), a * b = hi_a hi_b + hi_a lo_b + lo_a hi_b with float32
// accumulation, the small terms first (mma.sync m16n8k8, TF32 in, float32
// out).  Built with -fmad=false: the CUDA-core arithmetic rounds as the
// plain version's does, so "vpu" is bit-identical to it; the products
// differ from float32 in the last bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSph = 128;  // spheres per block
constexpr int kPar = 13;   // fetched parameters
constexpr int kVpuThreads = 256;
constexpr float kBig = 3.0e38f;
constexpr float kTMin = 1e-3f;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x as hi + lo, both TF32.
__device__ __forceinline__ void split(float x, uint32_t* hi, uint32_t* lo) {
  *hi = tf32(x);
  *lo = tf32(x - __uint_as_float(*hi));
}

// d += a b on a 16x8x8 tile: a row-major 16x8, b column-major 8x8.
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: d += (ahi + alo)(bhi + blo) without the lo x lo term.
__device__ __forceinline__ void mma3(float* d, const uint32_t* ahi,
                                     const uint32_t* alo, const uint32_t* bhi,
                                     const uint32_t* blo) {
  mma(d, alo, bhi);
  mma(d, ahi, blo);
  mma(d, ahi, bhi);
}

// A fragment (rows r0, r0 + 8; columns k0, k0 + 4 of a row-major matrix
// with row stride `ld`), split into hi and lo.
__device__ __forceinline__ void a_frag(const float* m, int ld, int r0, int k0,
                                       uint32_t* hi, uint32_t* lo) {
  split(m[r0 * ld + k0], &hi[0], &lo[0]);
  split(m[(r0 + 8) * ld + k0], &hi[1], &lo[1]);
  split(m[r0 * ld + k0 + 4], &hi[2], &lo[2]);
  split(m[(r0 + 8) * ld + k0 + 4], &hi[3], &lo[3]);
}

// The pair test from h and c (tools/mxu_probe.py:158-170): t, or kBig.
__device__ __forceinline__ float pair_t(float h, float cc, float a,
                                        float inv_a, float best) {
  const float disc = h * h - a * cc;
  const bool pos = disc > 0.0f;
  const float sq = sqrtf(pos ? disc : 1.0f);
  const float near = (-h - sq) * inv_a;
  const float far = (-h + sq) * inv_a;
  const bool near_ok = near >= kTMin && near <= best;
  const bool far_ok = far >= kTMin && far <= best;
  const float t = near_ok ? near : far;
  return pos && (near_ok || far_ok) ? t : kBig;
}

// (t, k) <- the better of (t, k) and (t2, k2): the smaller t, on a tie
// the smaller index (the first minimal t in table order).
__device__ __forceinline__ void keep_min(float* t, int* k, float t2, int k2) {
  if (t2 < *t || (t2 == *t && k2 < *k)) {
    *t = t2;
    *k = k2;
  }
}

// The winners' parameters of a warp's 32 lanes as the one-hot x block
// product: blk the block's (128, 16) rows, k the calling lane's winner in
// the block.  Writes fbuf[p * 32 + lane] for the 16 parameters.
__device__ __forceinline__ void fetch_onehot(const float* blk, int k,
                                             float* fbuf) {
  const int wl = threadIdx.x & 31, g = wl >> 2, t = wl & 3;
  int kn[4];
  for (int j = 0; j < 4; ++j) kn[j] = __shfl_sync(0xFFFFFFFFu, k, j * 8 + g);
  float acc[4][4] = {};
  const uint32_t zero[2] = {0u, 0u};
  for (int kk = 0; kk < kSph / 8; ++kk) {
    // A[m = parameter][k = sphere] = blk[sphere][parameter].
    uint32_t ahi[4], alo[4];
    split(blk[(kk * 8 + t) * 16 + g], &ahi[0], &alo[0]);
    split(blk[(kk * 8 + t) * 16 + g + 8], &ahi[1], &alo[1]);
    split(blk[(kk * 8 + t + 4) * 16 + g], &ahi[2], &alo[2]);
    split(blk[(kk * 8 + t + 4) * 16 + g + 8], &ahi[3], &alo[3]);
    for (int j = 0; j < 4; ++j) {
      const uint32_t b[2] = {
          kk * 8 + t == kn[j] ? __float_as_uint(1.0f) : 0u,
          kk * 8 + t + 4 == kn[j] ? __float_as_uint(1.0f) : 0u};
      mma3(acc[j], ahi, alo, b, zero);
    }
  }
  for (int j = 0; j < 4; ++j) {
    const int n = j * 8 + 2 * t;
    fbuf[g * 32 + n] = acc[j][0];
    fbuf[g * 32 + n + 1] = acc[j][1];
    fbuf[(g + 8) * 32 + n] = acc[j][2];
    fbuf[(g + 8) * 32 + n + 1] = acc[j][3];
  }
}

template <bool kMxuFetch>
__global__ void __launch_bounds__(kVpuThreads)
    probe_vpu(const float* __restrict__ table, const float* __restrict__ state,
              int n_lanes, int n_blocks, int iters, float* __restrict__ out) {
  extern __shared__ float sm[];  // the table, then 8 warps' fetch buffers
  float* tbl = sm;
  for (int i = threadIdx.x; i < n_blocks * kSph * 16; i += blockDim.x)
    tbl[i] = table[i];
  __syncthreads();
  float* fbuf = sm + n_blocks * kSph * 16 + (threadIdx.x / 32) * 16 * 32;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const float ox = state[lane], oy = state[n_lanes + lane];
  const float oz = state[2 * n_lanes + lane], dx = state[3 * n_lanes + lane];
  const float dy = state[4 * n_lanes + lane], dz = state[5 * n_lanes + lane];
  const float tm = state[6 * n_lanes + lane];
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  float acc = 0.0f;
  for (int it = 0; it < iters; ++it) {
    asm volatile("" ::: "memory");  // each iteration sweeps anew
    float best = kBig, par[kPar] = {};
    for (int b = 0; b < n_blocks; ++b) {
      const float* blk = tbl + b * kSph * 16;
      float bt = kBig;
      int bk = 0;
      for (int s = 0; s < kSph; ++s) {
        const float* row = blk + s * 16;
        const float ocx = ox - (row[0] + tm * row[3]);
        const float ocy = oy - (row[1] + tm * row[4]);
        const float ocz = oz - (row[2] + tm * row[5]);
        const float h = ocx * dx + ocy * dy + ocz * dz;
        const float cc = ocx * ocx + ocy * ocy + ocz * ocz - row[6] * row[6];
        const float tp = pair_t(h, cc, a, inv_a, best);
        if (tp < bt) {
          bt = tp;
          bk = s;
        }
      }
      const bool upd = bt < best;
      if constexpr (kMxuFetch) {
        fetch_onehot(blk, bk, fbuf);
        __syncwarp();
        if (upd)
          for (int p = 0; p < kPar; ++p) par[p] = fbuf[p * 32 + (lane & 31)];
        __syncwarp();
      } else if (upd) {
        for (int p = 0; p < kPar; ++p) par[p] = blk[bk * 16 + p];
      }
      if (upd) best = bt;
    }
    const float t_ok = best < kBig ? best : 0.0f;
    acc = acc + t_ok + par[0] * 0.25f + par[3] * 0.5f + par[6];
  }
  out[lane] = acc;
}

// The lanes' scalars and the sweep's per-lane state, in shared memory.
struct LaneArrays {
  float *od, *oo, *a, *inv_a, *best, *blk_t;
  int* blk_k;
};

template <int kRows>
__global__ void __launch_bounds__(kRows * kLanes)
    probe_mxu(const float* __restrict__ table, const float* __restrict__ w,
              const float* __restrict__ state, int n_lanes, int n_blocks,
              int iters, float* __restrict__ out) {
  constexpr int kL = kRows * kLanes;  // lanes (threads) of the CTA
  extern __shared__ float sm[];
  float* sw = sm;                  // the block's (256, 16) weights
  float* st = sw + 2 * kSph * 16;  // the block's (128, 16) rows
  float* base = st + kSph * 16;
  const LaneArrays L{base,          base + kL,     base + 2 * kL,
                     base + 3 * kL, base + 4 * kL, base + 5 * kL,
                     reinterpret_cast<int*>(base + 6 * kL)};
  const int tid = threadIdx.x, warp = tid / 32, wl = tid & 31;
  const int g = wl >> 2, t = wl & 3;
  float* fbuf = base + 7 * kL + warp * 16 * 32;
  const int lane0 = blockIdx.x * kL;

  // The lane's scalars (each thread its own lane) ...
  {
    const int n = lane0 + tid;
    const float ox = state[n], oy = state[n_lanes + n];
    const float oz = state[2 * n_lanes + n], dx = state[3 * n_lanes + n];
    const float dy = state[4 * n_lanes + n], dz = state[5 * n_lanes + n];
    L.a[tid] = dx * dx + dy * dy + dz * dz;
    L.inv_a[tid] = 1.0f / L.a[tid];
    L.od[tid] = ox * dx + oy * dy + oz * dz;
    L.oo[tid] = ox * ox + oy * oy + oz * oz;
  }
  // ... and the B fragments of the warp's features: n-tile j holds lanes
  // j * 8 .. j * 8 + 7 of the warp, k-step ks features ks * 8 .. ks * 8 + 7;
  // this thread's are features ks * 8 + t and + 4 of lane j * 8 + g.
  uint32_t bhi[4][2][2], blo[4][2][2];
  for (int j = 0; j < 4; ++j) {
    const int n = lane0 + warp * 32 + j * 8 + g;
    const float ox = state[n], oy = state[n_lanes + n];
    const float oz = state[2 * n_lanes + n], dx = state[3 * n_lanes + n];
    const float dy = state[4 * n_lanes + n], dz = state[5 * n_lanes + n];
    const float tm = state[6 * n_lanes + n];
    const float f[16] = {dx,      dy,      dz,      tm * dx, tm * dy, tm * dz,
                         ox,      oy,      oz,      tm * ox, tm * oy, tm * oz,
                         1.0f,    tm,      tm * tm, 0.0f};
    for (int ks = 0; ks < 2; ++ks) {
      split(f[ks * 8 + t], &bhi[j][ks][0], &blo[j][ks][0]);
      split(f[ks * 8 + t + 4], &bhi[j][ks][1], &blo[j][ks][1]);
    }
  }

  float acc = 0.0f;
  for (int it = 0; it < iters; ++it) {
    float best = kBig, par[kPar] = {};
    L.best[tid] = kBig;
    for (int b = 0; b < n_blocks; ++b) {
      __syncthreads();  // the previous block's rows are no longer read
      for (int i = tid; i < 2 * kSph * 16; i += kL)
        sw[i] = w[b * 2 * kSph * 16 + i];
      for (int i = tid; i < kSph * 16; i += kL)
        st[i] = table[b * kSph * 16 + i];
      __syncthreads();
      // ---- h and c on the tensor cores, 16 spheres x 8 lanes at a time ---
      float run_t[4][2];
      int run_k[4][2];
      for (int j = 0; j < 4; ++j)
        for (int e = 0; e < 2; ++e) {
          run_t[j][e] = kBig;
          run_k[j][e] = 0;
        }
      for (int mt = 0; mt < kSph / 16; ++mt) {
        for (int j = 0; j < 4; ++j) {
          float h[4] = {}, c[4] = {};
          for (int ks = 0; ks < 2; ++ks) {
            uint32_t hhi[4], hlo[4], chi[4], clo[4];
            a_frag(sw, 16, mt * 16 + g, ks * 8 + t, hhi, hlo);
            a_frag(sw, 16, kSph + mt * 16 + g, ks * 8 + t, chi, clo);
            mma3(h, hhi, hlo, bhi[j][ks], blo[j][ks]);
            mma3(c, chi, clo, bhi[j][ks], blo[j][ks]);
          }
          // ---- the quadratic, and the min over the tile's 16 spheres ------
          for (int e = 0; e < 2; ++e) {
            const int n = warp * 32 + j * 8 + 2 * t + e;  // the CTA's lane
            const float a = L.a[n], ia = L.inv_a[n], bst = L.best[n];
            const float od = L.od[n], oo = L.oo[n];
            float tt = pair_t(h[e] + od, c[e] + oo, a, ia, bst);
            int kk = mt * 16 + g;
            keep_min(&tt, &kk,
                     pair_t(h[2 + e] + od, c[2 + e] + oo, a, ia, bst),
                     mt * 16 + g + 8);
            for (int off = 4; off < 32; off <<= 1)
              keep_min(&tt, &kk, __shfl_xor_sync(0xFFFFFFFFu, tt, off),
                       __shfl_xor_sync(0xFFFFFFFFu, kk, off));
            keep_min(&run_t[j][e], &run_k[j][e], tt, kk);
          }
        }
      }
      if (g == 0)
        for (int j = 0; j < 4; ++j)
          for (int e = 0; e < 2; ++e) {
            const int n = warp * 32 + j * 8 + 2 * t + e;
            L.blk_t[n] = run_t[j][e];
            L.blk_k[n] = run_k[j][e];
          }
      __syncwarp();
      // ---- the winners' parameters as a product -------------------------
      fetch_onehot(st, L.blk_k[tid], fbuf);
      __syncwarp();
      const float bt = L.blk_t[tid];
      if (bt < best) {
        best = bt;
        for (int p = 0; p < kPar; ++p) par[p] = fbuf[p * 32 + wl];
      }
      L.best[tid] = best;
      __syncwarp();
    }
    const float t_ok = best < kBig ? best : 0.0f;
    acc = acc + t_ok + par[0] * 0.25f + par[3] * 0.5f + par[6];
  }
  out[lane0 + tid] = acc;
}

}  // namespace

extern "C" {

// Launches kind 0 "vpu", 1 "mxu", 2 "mxu_b" or 3 "mxu_f" on `stream`.
// tbl: (n_blocks * 128, 16) float32; w: (2 * n_blocks * 128, 16) float32;
// state: (7, n_lanes) float32 (ox oy oz dx dy dz tm), n_lanes a multiple of
// 1,024; out: (n_lanes,) float32.  Returns the cudaError_t of the launch.
int rtow_mxu_probe(int kind, const float* tbl, const float* w,
                   const float* state, int n_lanes, int n_blocks, int iters,
                   float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_lanes % 1024 || n_blocks < 1 || iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int table = n_blocks * kSph * 16 * static_cast<int>(sizeof(float));
  if (kind == 0 || kind == 3) {
    const int smem = table + (kind == 3 ? kVpuThreads * 16 * 4 : 0);
    auto kernel = kind == 3 ? probe_vpu<true> : probe_vpu<false>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_lanes / kVpuThreads, kVpuThreads, smem, st>>>(
        tbl, state, n_lanes, n_blocks, iters, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (kind == 1 || kind == 2) {
    const int rows = kind == 1 ? 1 : 8, threads = rows * kLanes;
    // weights and rows of a block, 7 lane arrays, a fetch buffer per warp
    const int smem = (3 * kSph * 16 + 7 * threads + threads / 32 * 16 * 32) *
                     static_cast<int>(sizeof(float));
    auto kernel = kind == 1 ? probe_mxu<1> : probe_mxu<8>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<n_lanes / threads, threads, smem, st>>>(tbl, w, state, n_lanes,
                                                     n_blocks, iters, out);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
