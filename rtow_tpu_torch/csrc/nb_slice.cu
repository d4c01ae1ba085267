// The block-by-block table sum T2: the first 128 columns of every
// (16, width) block of an (NB, 16, width) float32 table, summed, broadcast
// to an (8, 128) float32 output.
//
// Replaces tools/repro_nb_slice.py:make_kernel (a fori_loop of dynamic
// major-dimension slices of a VMEM table, summed into one scalar).  The
// plain PyTorch version is nb_slice_reference in
// rtow_tpu_torch/tools/repro_nb_slice.py; the wrapper is nb_slice.
//
// One launch.  n_cta CTAs of 256 threads each sum a contiguous range of
// blocks, each thread two 16-byte loads of a block's 512 float4
// (neighbouring threads on neighbouring addresses), then a warp-shuffle
// and shared-memory tree inside the CTA, and write their partial.  Each
// CTA then draws a ticket from a counter in global memory (after a
// __threadfence, so its partial is visible first); the CTA that draws the
// last one adds the partials in CTA order, writes the 1,024 outputs and
// sets the counter back to 0 for the next launch.  The order of every sum
// is fixed by NB, so the result is the same from run to run (and the same,
// bit for bit, as an earlier two-launch form's, whose second launch added
// the same partials in the same order).  The partials and the counter are
// scratch that the wrapper allocates once, zeroed, and keeps.
//
// What bounds it on Hopper: the table's bytes, read once (8 KB a block:
// 11.5 MB at NB = 1,408, 3.4 us at 3.35 TB/s), against a launch's fixed
// costs on the card, and on the host the launch and the wrapper's Python
// around it.  At NB = 1,408 on an NVIDIA H100 80GB HBM3 (700 W) a call
// took 19.1 us (torch.sum 17.3 us) and the device alone 10.4 us (torch.sum
// 13.1 us; a CUDA graph of 100 calls).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr int kCols = 128;  // the columns summed of each row

__global__ void __launch_bounds__(kThreads)
    nb_slice(const float* __restrict__ tbl, int nb, int width, int per_cta,
             float* partial, unsigned int* ticket, float* __restrict__ out) {
  __shared__ float warp_sum[kThreads / 32];
  __shared__ float total;
  __shared__ bool last;
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
    __threadfence();  // the partial before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) {
    __threadfence();  // every other CTA's partial after its ticket
    const volatile float* p = partial;
    float t = 0.0f;
    for (unsigned int i = 0; i < gridDim.x; ++i) t += p[i];
    total = t;
    *ticket = 0u;  // ready for the next launch
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * 128; i += kThreads) out[i] = total;
}

}  // namespace

extern "C" {

// tbl: (nb, 16, width) float32, 16-byte aligned, width 128 or 256;
// scratch: one uint32 counter that is 0 between launches (zero it once),
// then n_cta floats of partials; out: (8, 128) float32.  Launches on
// `stream`; returns the cudaError_t of the launch.  Launches that share a
// scratch must run one after another (one stream).
int rtow_nb_slice(const float* tbl, int nb, int width, void* scratch,
                  int n_cta, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb < 1 || n_cta < 1 || n_cta > nb || (width != 128 && width != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_cta = (nb + n_cta - 1) / n_cta;
  const int ctas = (nb + per_cta - 1) / per_cta;
  unsigned int* ticket = static_cast<unsigned int*>(scratch);
  float* partial = reinterpret_cast<float*>(ticket + 1);
  nb_slice<<<ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tbl, nb, width, per_cta, partial, ticket, out);
  return static_cast<int>(cudaGetLastError());
}

const char* rtow_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
