// The sorted lanes' spatial keys: one (L,) int64 key a lane, dead lanes
// last, with no host round trip.
//
// Replaces no TPU kernel: the JAX package computes the key in jnp
// (rtow_tpu/ops/wavefront_sorted.py:sort_keys, :77), and the port's plain
// version, rtow_tpu_torch/ops/wavefront.py:sort_keys_reference, issues
// ~60 PyTorch operators a call, each launched from the host, two of them
// reductions.  The gradient path sorts its lanes before each bounce
// (ops/grad.py:_sort_lanes), the sorted wavefront before each of its
// bounces (ops/wavefront.py:_sorted); the wrapper is wavefront.sort_keys.
// The lane arithmetic is in sort_keys.cuh.
//
// Two launches, a fixed number whatever L:
//   1. sort_range: the min and max of each axis of the live lanes' unit
//      direction (a dead lane counts as +kBig / -kBig, as the plain
//      version's torch.where), NaN propagating.  n_cta CTAs of 256
//      threads stride over the lanes, reduce in the warp by shuffles and
//      in the CTA through shared memory, and write their six partials;
//      each then draws a ticket from a counter in global memory (after a
//      __threadfence); the CTA that draws the last one combines the
//      partials (all its threads, then a tree), writes each axis's lo and
//      scale (31.999 / max(hi - lo, 1e-6)) and sets the counter back to 0
//      for the next launch (T2's pattern, nb_slice.cu).  Min and max are
//      order-free, so the result does not depend on the CTAs' order.
//   2. sort_key: one thread a lane, the key from the origin on the grid
//      (bmin, inv_ext, device pointers) and the direction on the range.
//
// What bounds it on Hopper: bytes.  The least is the six ray rows and the
// alive row read once and the key written once, 36 B a lane: 37.7 MB at
// the gradient path's 1,048,576 lanes, 11.3 us at 3.35 TB/s.  The two
// passes read 16 + 28 B a lane and write 8 (16.3 us), against the fixed
// cost of two launches.  The rows are read with a row stride (the
// wavefront's window views of its packed state), lanes adjacent, so loads
// coalesce.

#include <cuda_runtime.h>

#include "sort_keys.cuh"

namespace {

namespace K = rtow::keys;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

RTOW_HD bool is_live(float a) { return a > 0.0f; }
RTOW_HD bool is_live(int a) { return a > 0; }

// The six running values: lo x y z, hi x y z.
struct Range {
  float v[6];
};

__device__ void fold(Range& r, const Range& o) {
  for (int a = 0; a < 3; ++a) {
    r.v[a] = K::min_nan(r.v[a], o.v[a]);
    r.v[3 + a] = K::max_nan(r.v[3 + a], o.v[3 + a]);
  }
}

// The CTA's fold of every thread's r, returned to thread 0.
__device__ Range fold_cta(Range r, Range* warp_part) {
  for (int off = 16; off > 0; off >>= 1) {
    Range o;
    for (int j = 0; j < 6; ++j)
      o.v[j] = __shfl_down_sync(0xFFFFFFFFu, r.v[j], off);
    fold(r, o);
  }
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x / 32] = r;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) fold(r, warp_part[w]);
  return r;
}

template <typename A>
__global__ void __launch_bounds__(kThreads)
    sort_range(const float* __restrict__ ray, long long stride,
               const A* __restrict__ alive, int n, float* partial,
               unsigned int* ticket, float* __restrict__ lo_scale) {
  __shared__ Range warp_part[kWarps];
  __shared__ bool last;
  Range r = {{K::kBig, K::kBig, K::kBig, -K::kBig, -K::kBig, -K::kBig}};
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < n;
       g += gridDim.x * kThreads) {
    if (!is_live(alive[g])) continue;
    float nd[3];
    K::unit_dir(ray[3 * stride + g], ray[4 * stride + g],
                ray[5 * stride + g], nd);
    for (int a = 0; a < 3; ++a) {
      r.v[a] = K::min_nan(r.v[a], nd[a]);
      r.v[3 + a] = K::max_nan(r.v[3 + a], nd[a]);
    }
  }
  r = fold_cta(r, warp_part);
  if (threadIdx.x == 0) {
    for (int j = 0; j < 6; ++j) partial[6 * blockIdx.x + j] = r.v[j];
    __threadfence();  // the partials before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other CTA's partials after its ticket
  const volatile float* p = partial;
  Range c = {{K::kBig, K::kBig, K::kBig, -K::kBig, -K::kBig, -K::kBig}};
  for (unsigned int b = threadIdx.x; b < gridDim.x; b += kThreads) {
    Range o;
    for (int j = 0; j < 6; ++j) o.v[j] = p[6 * b + j];
    fold(c, o);
  }
  c = fold_cta(c, warp_part);  // thread 0 read warp_part before `last`
  if (threadIdx.x == 0) {
    for (int a = 0; a < 3; ++a) {
      lo_scale[a] = c.v[a];
      lo_scale[3 + a] = K::dir_scale(c.v[a], c.v[3 + a]);
    }
    *ticket = 0u;  // ready for the next launch
  }
}

template <typename A>
__global__ void __launch_bounds__(kThreads)
    sort_key(const float* __restrict__ ray, long long stride,
             const A* __restrict__ alive, int n,
             const float* __restrict__ bmin, const float* __restrict__ inv_ext,
             const float* __restrict__ lo_scale, long long* __restrict__ out) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  if (!is_live(alive[g])) {
    out[g] = K::kDeadKey;
    return;
  }
  const float o[3] = {ray[g], ray[stride + g], ray[2 * stride + g]};
  float nd[3];
  K::unit_dir(ray[3 * stride + g], ray[4 * stride + g], ray[5 * stride + g],
              nd);
  const float grid_lo[3] = {bmin[0], bmin[1], bmin[2]};
  const float grid_inv[3] = {inv_ext[0], inv_ext[1], inv_ext[2]};
  const float lo[3] = {lo_scale[0], lo_scale[1], lo_scale[2]};
  const float scale[3] = {lo_scale[3], lo_scale[4], lo_scale[5]};
  out[g] = K::lane_key(o, nd, grid_lo, grid_inv, lo, scale);
}

template <typename A>
cudaError_t launch(const float* ray, long long stride, const A* alive, int n,
                   const float* bmin, const float* inv_ext, void* scratch,
                   int n_cta, long long* out, cudaStream_t stream) {
  unsigned int* ticket = static_cast<unsigned int*>(scratch);
  float* lo_scale = reinterpret_cast<float*>(ticket + 1);
  float* partial = lo_scale + 6;
  sort_range<A><<<n_cta, kThreads, 0, stream>>>(ray, stride, alive, n,
                                                partial, ticket, lo_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sort_key<A><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      ray, stride, alive, n, bmin, inv_ext, lo_scale, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ray: six float32 rows ox oy oz dx dy dz, row r at ray + r * stride, lanes
// adjacent; alive: n lanes, int32 (alive_f32 0) or float32 (1), live where
// > 0; bmin, inv_ext: 3 float32 each; scratch: one uint32 counter that is
// 0 between launches (zero it once), then 6 floats of lo and scale, then
// 6 * n_cta floats of partials; out: n int64.  Launches both passes on
// `stream`; returns the cudaError_t of the launches.  Launches that share
// a scratch must run one after another (one stream).
int rtow_sort_keys(const float* ray, long long stride, const void* alive,
                   int alive_f32, int n, const float* bmin,
                   const float* inv_ext, void* scratch, int n_cta,
                   long long* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || n_cta < 1 || stride < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = alive_f32
            ? launch(ray, stride, static_cast<const float*>(alive), n, bmin,
                     inv_ext, scratch, n_cta, out, s)
            : launch(ray, stride, static_cast<const int*>(alive), n, bmin,
                     inv_ext, scratch, n_cta, out, s);
  return static_cast<int>(err);
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
