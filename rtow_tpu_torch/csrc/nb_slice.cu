// The block-by-block table sum T2: the first 128 columns of every
// (16, width) block of an (NB, 16, width) float32 table, summed, broadcast
// to an (8, 128) float32 output.
//
// Replaces tools/repro_nb_slice.py:make_kernel (a fori_loop of dynamic
// major-dimension slices of a VMEM table, summed into one scalar).  The
// plain PyTorch version is nb_slice_reference in
// rtow_tpu_torch/tools/repro_nb_slice.py; the wrapper is nb_slice.
//
// What bounds it on Hopper: bytes.  The table (up to 1,408 x 16 x 256 x
// 4 B = 23 MB) does not fit shared memory, and every value it needs is read
// once: 8 KB a block.  Stage 1: n_cta CTAs of 256 threads each sum a
// contiguous range of blocks, each thread two 16-byte loads of a block's
// 512 float4 (neighbouring threads on neighbouring addresses), then a
// warp-shuffle and shared-memory tree inside the CTA.  Stage 2: one CTA
// adds the partials in block order and writes the 1,024 outputs.  The
// order of every sum is fixed by NB, so the result is the same from run to
// run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr int kCols = 128;  // the columns summed of each row

__global__ void __launch_bounds__(kThreads)
    nb_partial(const float* __restrict__ tbl, int nb, int width, int per_cta,
               float* __restrict__ partial) {
  __shared__ float warp_sum[kThreads / 32];
  const int b0 = blockIdx.x * per_cta;
  const int b1 = min(nb, b0 + per_cta);
  float s = 0.0f;
  for (int b = b0; b < b1; ++b) {
    const float* blk = tbl + static_cast<size_t>(b) * kRows * width;
    for (int i = threadIdx.x; i < kRows * kCols / 4; i += kThreads) {
      const float4 v = reinterpret_cast<const float4*>(
          blk + (i / (kCols / 4)) * width)[i % (kCols / 4)];
      s += (v.x + v.y) + (v.z + v.w);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xFFFFFFFFu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_sum[w];
    partial[blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
    nb_final(const float* __restrict__ partial, int n,
             float* __restrict__ out) {
  __shared__ float total;
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int i = 0; i < n; ++i) t += partial[i];
    total = t;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * 128; i += kThreads) out[i] = total;
}

}  // namespace

extern "C" {

// tbl: (nb, 16, width) float32, 16-byte aligned, width 128 or 256;
// partial: (n_cta,) float32 scratch; out: (8, 128) float32.  Launches both
// stages on `stream`; returns the cudaError_t of the launches.
int rtow_nb_slice(const float* tbl, int nb, int width, float* partial,
                  int n_cta, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb < 1 || n_cta < 1 || n_cta > nb || (width != 128 && width != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int per_cta = (nb + n_cta - 1) / n_cta;
  const int ctas = (nb + per_cta - 1) / per_cta;
  nb_partial<<<ctas, kThreads, 0, st>>>(tbl, nb, width, per_cta, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nb_final<<<1, kThreads, 0, st>>>(partial, ctas, out);
  return static_cast<int>(cudaGetLastError());
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
