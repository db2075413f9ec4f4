// Chan's merge of (count, mean, M2) states, shared by the statistics of
// K3's pointwise_stats (pointwise.cu) and the BatchNorm kernels
// (batchnorm.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

// (n, mean, m2) ← (n, mean, m2) merged with (nb, mb, m2b), Chan's formula
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb == 0.0f) return;
  if (n == 0.0f) {
    n = nb, mean = mb, m2 = m2b;
    return;
  }
  const float nn = n + nb, d = mb - mean, f = nb / nn;
  mean = mean + d * f;
  m2 = m2 + m2b + d * d * n * f;
  n = nn;
}

// merge the states of the lanes l ^ off, off < width, in a fixed order
__device__ __forceinline__ void chan_merge_lanes(float& n, float& mean, float& m2, int width) {
  for (int off = 1; off < width; off <<= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, off);
    const float mb = __shfl_xor_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
    chan_merge(n, mean, m2, nb, mb, m2b);
  }
}

}  // namespace
