// The sorted lanes' spatial key of one lane: device code of sort_keys.cu,
// shared with the host build in host_lanes.cpp.
//
// The arithmetic of the plain version, rtow_tpu_torch/ops/wavefront.py:
// sort_keys_reference, operation for operation and in its order, so that
// the key is the same bit for bit (the key fixes the permutation of the
// lanes, and the permutation the order of every gradient sum).  A 30-bit
// Morton code whose 3-bit groups alternate origin and direction, origin
// first: the origin quantised to 5 bits per axis on the fixed scene grid
// ((o - bmin) * inv_ext * 31), the unit direction (d * (1 / sqrt(|d|^2)),
// not rsqrt) to 5 bits per axis over the live lanes' range
// ((nd - lo) * (31.999 / max(hi - lo, 1e-6)), the division a true one);
// each clamped to [0, 31], then truncated to an integer.  Dead lanes
// (alive <= 0) take kDeadKey.
//
// The live range is a min and a max that propagate NaN as torch.min and
// torch.max do, and clamps that pass NaN through as torch.clamp does: a
// live lane with a NaN direction makes every live lane's direction code 0,
// in both versions.
//
// float32 throughout; built with -fmad=false (nvcc) or -ffp-contract=off
// (g++) and IEEE division and square root, every operation rounds as in
// the plain version.  A host build defines RTOW_HD (as `inline`) before
// including this header.

#pragma once

#include <math.h>
#include <stdint.h>

#ifndef RTOW_HD
#define RTOW_HD __host__ __device__ __forceinline__
#endif

namespace rtow {
namespace keys {

constexpr long long kDeadKey = 0x7FFFFFFF;
constexpr float kLim = 31.0f;      // the largest cell of an axis
constexpr float kTop = 31.999f;    // the direction's scale numerator
constexpr float kMinSpan = 1e-6f;  // the direction range's floor
constexpr float kBig = 3.0e38f;    // a dead lane's stand-in for min / max

// torch.min's and torch.max's pairwise steps: a NaN on either side wins.
RTOW_HD float min_nan(float a, float b) { return (a != a || a < b) ? a : b; }
RTOW_HD float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }

// torch.clamp(v, lo, hi): NaN passes through.
RTOW_HD float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// The unit direction of d, as 1 / sqrt then a product per axis.
RTOW_HD void unit_dir(float dx, float dy, float dz, float nd[3]) {
  const float inv_len = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  nd[0] = dx * inv_len;
  nd[1] = dy * inv_len;
  nd[2] = dz * inv_len;
}

// An axis's scale from its live range [lo, hi].
RTOW_HD float dir_scale(float lo, float hi) {
  const float span = hi - lo;
  return kTop / (span != span ? span : fmaxf(span, kMinSpan));
}

// Interleave the low 10 bits of x with two zero bits each (_spread3), in
// int64 as the plain version computes it.
RTOW_HD long long spread3(long long v) {
  unsigned long long x = static_cast<unsigned long long>(v);
  x = (x | (x << 16)) & 0x030000FFull;
  x = (x | (x << 8)) & 0x0300F00Full;
  x = (x | (x << 4)) & 0x030C30C3ull;
  return static_cast<long long>((x | (x << 2)) & 0x09249249ull);
}

// The Morton code of three quantised axes, x in the lowest bit.
RTOW_HD long long code3(float qx, float qy, float qz) {
  return spread3(static_cast<long long>(qx)) |
         (spread3(static_cast<long long>(qy)) << 1) |
         (spread3(static_cast<long long>(qz)) << 2);
}

// The key of a live lane: origin o, unit direction nd, the grid (bmin,
// inv_ext) and the live range's lo and scale per axis.
RTOW_HD long long lane_key(const float o[3], const float nd[3],
                           const float bmin[3], const float inv_ext[3],
                           const float lo[3], const float scale[3]) {
  float qo[3], qd[3];
  for (int a = 0; a < 3; ++a) {
    qo[a] = clamp_nan((o[a] - bmin[a]) * inv_ext[a] * kLim, 0.0f, kLim);
    qd[a] = clamp_nan((nd[a] - lo[a]) * scale[a], 0.0f, kLim);
  }
  const long long ocode = code3(qo[0], qo[1], qo[2]);
  const long long dcode = code3(qd[0], qd[1], qd[2]);
  long long key = 0;
  for (int i = 4; i >= 0; --i) {  // the most significant triplets first
    key = (key << 3) | ((ocode >> (3 * i)) & 7);
    key = (key << 3) | ((dcode >> (3 * i)) & 7);
  }
  return key;
}

}  // namespace keys
}  // namespace rtow
