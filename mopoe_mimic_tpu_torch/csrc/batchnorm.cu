// Train-mode BatchNorm of a bfloat16 input with float32 weight and bias,
// forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces ATen's NCHW BatchNorm kernels for such an input
// (aten/src/ATen/native/cuda/Normalization.cuh:
// batch_norm_collect_statistics_kernel, batch_norm_transform_input_kernel,
// batch_norm_backward_kernel; a bf16 input with float32 weights does not go
// to cuDNN). It corresponds to no Pallas kernel: the JAX package leaves its
// BatchNorm to XLA. For x [N, C, S] (the contiguous NCHW or NCL tensor with
// the spatial axes flattened; n = N * S elements a channel) it keeps ATen's
// arithmetic for this dtype pair:
//
//   mean, var = the batch mean and biased variance (float32),
//   invstd = 1 / sqrt(var + eps) (each operation correctly rounded),
//   y = bf16(gamma * (x - mean) * invstd + beta),
//   running_mean <- (1 - m) running_mean + m mean,
//   running_var  <- (1 - m) running_var + m var * n / (n - 1),
//
// and, from dy [N, C, S] (bf16) and the saved mean and invstd,
//
//   sum = sum dy,  dot = sum dy * (x - mean)                        (float32)
//   dx = bf16((dy - (x - mean) * dot / n * invstd^2 - sum / n) * invstd * gamma),
//   dgamma = dot * invstd,  dbeta = sum                              (float32)
//
// What bounds it on this card: bytes. The least traffic is 10 bytes an
// element (the forward reads x and writes y, the backward reads x and dy
// and writes dx), a few operations each: 2.8 ms a step for word's 96
// BatchNorms at 3.35 TB/s. ATen's statistics and backward kernels give one
// block to each channel, which walks the channel's N * S elements alone:
// 64 blocks on 132 SMs at the largest maps. Here the grid is chunks of N
// times groups of channels, and a warp reads 16 bytes a lane where S is a
// multiple of 8 and the rows are aligned (a scalar path takes the rest).
//
// Two designs, chosen by the shape (ops/cuda_batchnorm.bn_plan):
//
//  * Two passes each way, for slices too large to hold on chip. Forward:
//    bn_fwd_stats_kernel writes a Welford state (mean, M2) per (chunk,
//    channel); bn_fwd_apply_kernel merges the channel's states in a fixed
//    order (Chan's formula), writes y and, in the blocks of chunk 0, the
//    saved mean and invstd and the running update. Backward:
//    bn_bwd_reduce_kernel writes (sum, dot) per (chunk, channel);
//    bn_bwd_dx_kernel sums them in a fixed order, writes dx and, in chunk
//    0, dgamma and dbeta. 16 bytes an element, not 10: x is read twice each
//    way and dy twice; the second pass walks the blocks in the reverse
//    order of the first, so that it starts on what the first read last,
//    still in the 50 MB L2.
//  * One pass each way (bn_fwd_fused_kernel, bn_bwd_fused_kernel) where a
//    channel's whole slice fits in its lanes' registers (kHeld items of up
//    to 16 bytes a lane): one block holds a group of channels, reads x (and
//    dy) once, takes the statistics in two exact passes over the registers
//    and writes y (dx). Small BatchNorms are bound by launches and latency,
//    not bytes, and this halves the launches.
//
// No atomics: every sum has a fixed order, so two runs, and a graph's
// replay and the eager call, are bitwise equal. A lane's state merges with
// its neighbours' by xor shuffles; a sum is the same in every lane (a + b
// == b + a in floating point), a Chan merge is not and is taken from the
// channel's first lane.
//
// Channels innermost (bn_fwd_nhwc, bn_bwd_nhwc; ops/cuda_batchnorm.
// bn_plan_nhwc): x [R, C] row-major, the channels-last [N, C, H, W] tensor
// read in place (R = N * H * W). An item is VEC consecutive channels of one
// row (16 bytes where C is a multiple of 8), and a lane keeps one column of
// items, the same VEC channels, for the whole kernel: it walks rows, holds
// VEC channels' states in registers and reads each channel's mean, invstd
// and factors once. A block is a tile of `cols` columns by rps = kThreads /
// cols rows a step, so a warp's loads are one contiguous run of the rows;
// the rps lanes of a column merge in a fixed tree through shared memory.
// The same two designs:
//
//  * Two passes each way, over (column tiles, chunks of rows): the stats
//    (reduce) kernel writes a state per (chunk, channel); a finalize kernel,
//    a block for kFinC channels, merges a channel's chunks in a fixed order
//    (128 lanes a channel, then the tree) and writes the saved mean and
//    invstd and the running update (dgamma, dbeta and the sums the dx pass
//    reads); the apply (dx) kernel reads them, in the reverse block order.
//    Merging the chunks once, and not in every block of the second pass,
//    keeps a tile of all C channels from re-reading chunks x C partials.
//  * One pass each way (bn_nhwc_fwd_fused_kernel, bn_nhwc_bwd_fused_kernel)
//    where a column's R rows fit in the registers of a cluster of kCluster
//    blocks (kHeldRows items a lane): the cluster takes a tile of 8 columns
//    (ops/cuda_batchnorm.CLUSTER_COLS), each block an eighth of the rows,
//    and the blocks' sums are added in rank order through distributed
//    shared memory. One block a column tile would leave the card with C / 64
//    blocks at these shapes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "welford.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // items a lane loads before it uses them, two-pass kernels
constexpr int kHeld = 8;    // items a lane holds, one-pass kernels (ops/cuda_batchnorm.HELD)
constexpr unsigned kFull = 0xffffffffu;

// VEC consecutive bf16 elements along s: one 16-byte load, or one element
template <int VEC>
struct Vec;

template <>
struct Vec<8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned short*>(p);
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&v)[1]) {
    v[0] = __uint_as_float((unsigned)r << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

// The items of channel c in b in [b_begin, b_end) that a lane takes: with
// G = S / VEC items a (b, c) run, item j of the chunk lies at
// b = b_begin + j / G, s = (j % G) * VEC, and the lane takes j = sub,
// sub + tpc, ... The position moves without a division.
struct Walk {
  int b, g, step_b, step_g, G;
  __device__ __forceinline__ Walk(int b_begin, int sub, int tpc, int G_)
      : b(b_begin + sub / G_), g(sub % G_), step_b(tpc / G_), step_g(tpc % G_), G(G_) {}
  __device__ __forceinline__ void next() {
    b += step_b;
    g += step_g;
    if (g >= G) {
      g -= G;
      ++b;
    }
  }
  __device__ __forceinline__ long long at(int c, int C, int S, int VEC) const {
    return ((long long)b * C + c) * S + (long long)g * VEC;
  }
};

// Up to U of the lane's next items with b < b_end: each one's offset, x's
// raw item and, where dy is given, dy's; returns how many (a prefix of
// the U). Every load is issued before any is used.
template <int VEC, int U>
__device__ __forceinline__ int load_items(Walk& w, int b_end, int c, int C, int S,
                                          const __nv_bfloat16* __restrict__ x,
                                          const __nv_bfloat16* __restrict__ dy,
                                          typename Vec<VEC>::Raw (&rx)[U],
                                          typename Vec<VEC>::Raw (&rd)[U], long long (&at)[U]) {
  int k = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (w.b < b_end) {
      at[u] = w.at(c, C, S, VEC);
      rx[u] = Vec<VEC>::load(x + at[u]);
      if (dy != nullptr) rd[u] = Vec<VEC>::load(dy + at[u]);
      k = u + 1;
      w.next();
    }
  }
  return k;
}

// The lanes of one channel in a block: tpc consecutive threads
struct Lanes {
  int tpc, sub, c;
  __device__ __forceinline__ Lanes(int tpc_, int group)
      : tpc(tpc_), sub(threadIdx.x % tpc_), c(group * (kThreads / tpc_) + threadIdx.x / tpc_) {}
};

// The sum of v over the tpc lanes of a channel, the same bits in every
// lane: xor shuffles within a warp, then, where tpc > 32, the channel's
// warps' sums in order through shared memory. Every thread of the block
// calls it (it may synchronise the block).
__device__ __forceinline__ float channel_sum(float v, int tpc, float* red) {
  const int width = tpc < 32 ? tpc : 32;
  for (int off = 1; off < width; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  if (tpc <= 32) return v;
  const int warp = threadIdx.x / 32, per = tpc / 32, first = warp / per * per;
  __syncthreads();  // the previous call's reads of red are done
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < per; ++i) s += red[first + i];
  return s;
}

__device__ __forceinline__ float inv_std(float var, float eps) {
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));  // never rsqrt
}

// nn.BatchNorm's running update, as mul_(1 - m).add_(stat, alpha=m)
// rounds on the card (pointwise_stats_finalize's rounding)
__device__ __forceinline__ void update_running(float* rm, float* rv, int c, float mean, float var,
                                               float m, float one_minus_m, float unbias) {
  rm[c] = __fmaf_rn(m, mean, __fmul_rn(rm[c], one_minus_m));
  rv[c] = __fmaf_rn(m, __fmul_rn(var, unbias), __fmul_rn(rv[c], one_minus_m));
}

// gamma * (x - mean) * invstd + beta, as ATen's transform rounds it
__device__ __forceinline__ float normalize(float x, float mean, float invstd, float gamma,
                                           float beta) {
  return __fmaf_rn(__fmul_rn(gamma, __fsub_rn(x, mean)), invstd, beta);
}

// The backward's per-channel factors (ATen's batch_norm_backward_kernel)
struct Grad {
  float mean, proj_scale, grad_mean, grad_scale;
  Grad() = default;
  __device__ __forceinline__ Grad(float sum, float dot, float n, float mean_, float invstd,
                                  float gamma) {
    const float norm = __fdiv_rn(1.0f, n);
    mean = mean_;
    grad_mean = __fmul_rn(sum, norm);
    proj_scale = __fmul_rn(__fmul_rn(__fmul_rn(dot, norm), invstd), invstd);
    grad_scale = __fmul_rn(invstd, gamma);
  }
  __device__ __forceinline__ float dx(float x, float dy) const {
    return __fmul_rn(__fsub_rn(__fmaf_rn(-__fsub_rn(x, mean), proj_scale, dy), grad_mean),
                     grad_scale);
  }
};

// ---------------------------------------------------------------------------
// two passes: grid (channel groups, chunks of N)
// ---------------------------------------------------------------------------

// Per (chunk, channel): the chunk's Welford state, part[0][chunk][c] the
// mean, part[1][chunk][c] M2. A lane joins its items kUnroll at a time as a
// batch pivoted on its running mean (the first element is the first
// pivot): with s1 = sum (x - mean), s2 = sum (x - mean)^2 over the batch,
// mean += s1 / n', M2 += s2 - s1^2 / n'. tpc <= 32.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_fwd_stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ part, int N, int C,
                    int S, int tpc, int b_per_chunk) {
  const Lanes l(tpc, blockIdx.x);
  const int chunk = blockIdx.y, b_begin = chunk * b_per_chunk;
  const int b_end = min(N, b_begin + b_per_chunk);
  float n = 0.0f, mean = 0.0f, m2 = 0.0f;
  if (l.c < C) {
    Walk w(b_begin, l.sub, tpc, S / VEC);
    while (w.b < b_end) {
      typename Vec<VEC>::Raw raw[kUnroll], unused[kUnroll];
      long long at[kUnroll];
      const int k = load_items<VEC, kUnroll>(w, b_end, l.c, C, S, x, nullptr, raw, unused, at);
      float v[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (u < k) Vec<VEC>::unpack(raw[u], v[u]);
      if (n == 0.0f) mean = v[0][0];
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u < k) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float d = v[u][j] - mean;
            s1 += d;
            s2 = fmaf(d, d, s2);
          }
        }
      }
      n += (float)(k * VEC);
      const float r = __frcp_rn(n);
      mean = mean + s1 * r;
      m2 = m2 + (s2 - s1 * s1 * r);
    }
  }
  chan_merge_lanes(n, mean, m2, tpc);
  if (l.c < C && l.sub == 0) {
    part[(long long)chunk * C + l.c] = mean;
    part[((long long)gridDim.y + chunk) * C + l.c] = m2;
  }
}

// The channel's chunk states merged in a fixed order (lane sub takes
// chunks sub, sub + tpc, ..., then xor merges), as the channel's first
// lane has it, in every lane of the channel: the same bits in every block.
__device__ __forceinline__ void merged_stats(const float* __restrict__ part, int chunks, int N,
                                             int C, int S, int b_per_chunk, const Lanes& l,
                                             float& mean, float& m2) {
  float n = 0.0f;
  mean = 0.0f, m2 = 0.0f;
  if (l.c < C) {
    for (int k = l.sub; k < chunks; k += l.tpc) {
      const int bs = min(N, (k + 1) * b_per_chunk) - k * b_per_chunk;
      chan_merge(n, mean, m2, (float)bs * (float)S, part[(long long)k * C + l.c],
                 part[((long long)chunks + k) * C + l.c]);
    }
  }
  chan_merge_lanes(n, mean, m2, l.tpc);
  const int first = (threadIdx.x % 32) & ~(l.tpc - 1);
  mean = __shfl_sync(kFull, mean, first);
  m2 = __shfl_sync(kFull, m2, first);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_fwd_apply_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ part,
                    const float* __restrict__ weight, const float* __restrict__ bias,
                    float* __restrict__ running_mean, float* __restrict__ running_var,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ save_mean,
                    float* __restrict__ save_invstd, int N, int C, int S, int tpc,
                    int b_per_chunk, float eps, float m, float one_minus_m, float unbias) {
  // the reverse of bn_fwd_stats_kernel's block order
  const Lanes l(tpc, gridDim.x - 1 - blockIdx.x);
  const int chunk = gridDim.y - 1 - blockIdx.y, b_begin = chunk * b_per_chunk;
  const int b_end = min(N, b_begin + b_per_chunk);
  float mean, m2;
  merged_stats(part, gridDim.y, N, C, S, b_per_chunk, l, mean, m2);
  if (l.c >= C) return;  // no block-wide step follows
  const float n = (float)N * (float)S;
  float var = __fdiv_rn(m2, n);
  if (var < 0.0f) var = 0.0f;  // M2 can round below 0; a NaN stays a NaN
  const float invstd = inv_std(var, eps);
  if (chunk == 0 && l.sub == 0) {
    save_mean[l.c] = mean;
    save_invstd[l.c] = invstd;
    update_running(running_mean, running_var, l.c, mean, var, m, one_minus_m, unbias);
  }
  const float gamma = weight[l.c], beta = bias[l.c];
  Walk w(b_begin, l.sub, tpc, S / VEC);
  while (w.b < b_end) {
    typename Vec<VEC>::Raw raw[kUnroll], unused[kUnroll];
    long long at[kUnroll];
    const int k = load_items<VEC, kUnroll>(w, b_end, l.c, C, S, x, nullptr, raw, unused, at);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < k) {
        float v[VEC];
        Vec<VEC>::unpack(raw[u], v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] = normalize(v[j], mean, invstd, gamma, beta);
        Vec<VEC>::store(y + at[u], v);
      }
    }
  }
}

// Per (chunk, channel): part[0][chunk][c] = sum dy, part[1][chunk][c] =
// sum dy * (x - mean) over the chunk. tpc <= 32.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_bwd_reduce_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                     const float* __restrict__ save_mean, float* __restrict__ part, int N, int C,
                     int S, int tpc, int b_per_chunk) {
  const Lanes l(tpc, blockIdx.x);
  const int chunk = blockIdx.y, b_begin = chunk * b_per_chunk;
  const int b_end = min(N, b_begin + b_per_chunk);
  float sum = 0.0f, dot = 0.0f;
  if (l.c < C) {
    const float mean = save_mean[l.c];
    Walk w(b_begin, l.sub, tpc, S / VEC);
    while (w.b < b_end) {
      typename Vec<VEC>::Raw rx[kUnroll], rd[kUnroll];
      long long at[kUnroll];
      const int k = load_items<VEC, kUnroll>(w, b_end, l.c, C, S, x, dy, rx, rd, at);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u < k) {
          float vx[VEC], vd[VEC];
          Vec<VEC>::unpack(rx[u], vx);
          Vec<VEC>::unpack(rd[u], vd);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            sum += vd[j];
            dot = fmaf(vd[j], vx[j] - mean, dot);
          }
        }
      }
    }
  }
  for (int off = 1; off < tpc; off <<= 1) {
    sum += __shfl_xor_sync(kFull, sum, off);
    dot += __shfl_xor_sync(kFull, dot, off);
  }
  if (l.c < C && l.sub == 0) {
    part[(long long)chunk * C + l.c] = sum;
    part[((long long)gridDim.y + chunk) * C + l.c] = dot;
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_bwd_dx_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                 const float* __restrict__ part, const float* __restrict__ weight,
                 const float* __restrict__ save_mean, const float* __restrict__ save_invstd,
                 __nv_bfloat16* __restrict__ dx, float* __restrict__ dweight,
                 float* __restrict__ dbias, int N, int C, int S, int tpc, int b_per_chunk) {
  const Lanes l(tpc, gridDim.x - 1 - blockIdx.x);  // the reverse of the reduce's order
  const int chunks = gridDim.y, chunk = chunks - 1 - blockIdx.y;
  const int b_begin = chunk * b_per_chunk, b_end = min(N, b_begin + b_per_chunk);
  float sum = 0.0f, dot = 0.0f;
  if (l.c < C) {
    for (int k = l.sub; k < chunks; k += tpc) {
      sum += part[(long long)k * C + l.c];
      dot += part[((long long)chunks + k) * C + l.c];
    }
  }
  for (int off = 1; off < tpc; off <<= 1) {  // a sum: the same bits in every lane
    sum += __shfl_xor_sync(kFull, sum, off);
    dot += __shfl_xor_sync(kFull, dot, off);
  }
  if (l.c >= C) return;
  const float invstd = save_invstd[l.c];
  if (chunk == 0 && l.sub == 0) {
    dweight[l.c] = __fmul_rn(dot, invstd);
    dbias[l.c] = sum;
  }
  const Grad g(sum, dot, (float)N * (float)S, save_mean[l.c], invstd, weight[l.c]);
  Walk w(b_begin, l.sub, tpc, S / VEC);
  while (w.b < b_end) {
    typename Vec<VEC>::Raw rx[kUnroll], rd[kUnroll];
    long long at[kUnroll];
    const int k = load_items<VEC, kUnroll>(w, b_end, l.c, C, S, x, dy, rx, rd, at);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < k) {
        float vx[VEC], vd[VEC];
        Vec<VEC>::unpack(rx[u], vx);
        Vec<VEC>::unpack(rd[u], vd);
#pragma unroll
        for (int j = 0; j < VEC; ++j) vx[j] = g.dx(vx[j], vd[j]);
        Vec<VEC>::store(dx + at[u], vx);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// one pass: grid (channel groups); a channel's tpc lanes hold its N * S
// elements, at most kHeld items a lane
// ---------------------------------------------------------------------------

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_fwd_fused_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ weight,
                    const float* __restrict__ bias, float* __restrict__ running_mean,
                    float* __restrict__ running_var, __nv_bfloat16* __restrict__ y,
                    float* __restrict__ save_mean, float* __restrict__ save_invstd, int N, int C,
                    int S, int tpc, float eps, float m, float one_minus_m, float unbias) {
  __shared__ float red[kThreads / 32];
  const Lanes l(tpc, blockIdx.x);
  typename Vec<VEC>::Raw raw[kHeld], unused[kHeld];
  long long at[kHeld];
  int k = 0;
  if (l.c < C) {
    Walk w(0, l.sub, tpc, S / VEC);
    k = load_items<VEC, kHeld>(w, N, l.c, C, S, x, nullptr, raw, unused, at);
  }
  const float n = (float)N * (float)S;
  float s = 0.0f;
#pragma unroll
  for (int u = 0; u < kHeld; ++u) {
    if (u < k) {
      float v[VEC];
      Vec<VEC>::unpack(raw[u], v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += v[j];
    }
  }
  const float mean = __fdiv_rn(channel_sum(s, tpc, red), n);
  float q = 0.0f;
#pragma unroll
  for (int u = 0; u < kHeld; ++u) {
    if (u < k) {
      float v[VEC];
      Vec<VEC>::unpack(raw[u], v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[j] - mean;
        q = fmaf(d, d, q);
      }
    }
  }
  const float var = __fdiv_rn(channel_sum(q, tpc, red), n);
  if (l.c >= C) return;  // no block-wide step follows
  const float invstd = inv_std(var, eps);
  if (l.sub == 0) {
    save_mean[l.c] = mean;
    save_invstd[l.c] = invstd;
    update_running(running_mean, running_var, l.c, mean, var, m, one_minus_m, unbias);
  }
  const float gamma = weight[l.c], beta = bias[l.c];
#pragma unroll
  for (int u = 0; u < kHeld; ++u) {
    if (u < k) {
      float v[VEC];
      Vec<VEC>::unpack(raw[u], v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = normalize(v[j], mean, invstd, gamma, beta);
      Vec<VEC>::store(y + at[u], v);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_bwd_fused_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                    const float* __restrict__ weight, const float* __restrict__ save_mean,
                    const float* __restrict__ save_invstd, __nv_bfloat16* __restrict__ dx,
                    float* __restrict__ dweight, float* __restrict__ dbias, int N, int C, int S,
                    int tpc) {
  __shared__ float red[kThreads / 32];
  const Lanes l(tpc, blockIdx.x);
  typename Vec<VEC>::Raw rx[kHeld], rd[kHeld];
  long long at[kHeld];
  int k = 0;
  float mean = 0.0f;
  if (l.c < C) {
    mean = save_mean[l.c];
    Walk w(0, l.sub, tpc, S / VEC);
    k = load_items<VEC, kHeld>(w, N, l.c, C, S, x, dy, rx, rd, at);
  }
  float sum = 0.0f, dot = 0.0f;
#pragma unroll
  for (int u = 0; u < kHeld; ++u) {
    if (u < k) {
      float vx[VEC], vd[VEC];
      Vec<VEC>::unpack(rx[u], vx);
      Vec<VEC>::unpack(rd[u], vd);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        sum += vd[j];
        dot = fmaf(vd[j], vx[j] - mean, dot);
      }
    }
  }
  sum = channel_sum(sum, tpc, red);
  dot = channel_sum(dot, tpc, red);
  if (l.c >= C) return;  // no block-wide step follows
  const float invstd = save_invstd[l.c];
  if (l.sub == 0) {
    dweight[l.c] = __fmul_rn(dot, invstd);
    dbias[l.c] = sum;
  }
  const Grad g(sum, dot, (float)N * (float)S, mean, invstd, weight[l.c]);
#pragma unroll
  for (int u = 0; u < kHeld; ++u) {
    if (u < k) {
      float vx[VEC], vd[VEC];
      Vec<VEC>::unpack(rx[u], vx);
      Vec<VEC>::unpack(rd[u], vd);
#pragma unroll
      for (int j = 0; j < VEC; ++j) vx[j] = g.dx(vx[j], vd[j]);
      Vec<VEC>::store(dx + at[u], vx);
    }
  }
}

// ---------------------------------------------------------------------------
// channels innermost: x [R, C] row-major, items of VEC channels
// ---------------------------------------------------------------------------

constexpr int kHeldRows = 16;  // rows a lane holds, one-pass kernels (cuda_batchnorm.HELD_ROWS)
constexpr int kFinC = 2;       // channels a finalize block: kThreads / kFinC lanes a channel
constexpr int kFinBatch = 8;   // partials a finalize lane loads at once
constexpr int kRowsAtOnce = 8;  // rows a lane loads before it uses them, two-pass kernels
constexpr int kCluster = 8;    // blocks of a one-pass cluster (the portable most)

// A lane's place in a block of cols columns by rps = kThreads / cols rows:
// column j (items from the row's start; its channels j * VEC ...), first
// row r of each step. on: the lane has a column (j < V) and a row slot.
struct Tile {
  int cols, rps, j, r;
  bool on;
  __device__ __forceinline__ Tile(int cols_, int tile, int V)
      : cols(cols_), rps(kThreads / cols_) {
    j = tile * cols + (int)threadIdx.x % cols;
    r = (int)threadIdx.x / cols;
    on = r < rps && j < V;
  }
};

// The first stride of a tree over rps slots: the largest power of two
// below rps (1 where rps <= 2)
__device__ __forceinline__ int tree_top(int rps) {
  int s = 1;
  while (2 * s < rps) s *= 2;
  return s;
}

// v[K] summed over the rps lanes of each column in a fixed tree (slot r
// takes slot r + s, s halving), the total in every lane of the column. sh:
// K * kThreads floats. Every thread of the block calls it.
template <int K>
__device__ __forceinline__ void column_sum(float (&v)[K], const Tile& t, float* sh) {
  const int me = threadIdx.x;
  __syncthreads();  // the previous call's reads of sh are done
#pragma unroll
  for (int i = 0; i < K; ++i) sh[i * kThreads + me] = v[i];
  for (int s = tree_top(t.rps); s >= 1; s >>= 1) {
    __syncthreads();
    if (t.r < s && t.r + s < t.rps) {
      const int o = me + s * t.cols;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        v[i] += sh[i * kThreads + o];
        sh[i * kThreads + me] = v[i];
      }
    }
  }
  __syncthreads();
  const int first = me % t.cols;  // the column's slot of row 0
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = sh[i * kThreads + first];
}

// Welford states (n, mean[K], m2[K]) merged over the rps lanes of each
// column by Chan's formula in the same fixed tree; the merged state in the
// column's lane of row 0. sh: (1 + 2K) * kThreads floats.
template <int K>
__device__ __forceinline__ void column_merge(float& n, float (&mean)[K], float (&m2)[K],
                                             const Tile& t, float* sh) {
  const int me = threadIdx.x;
  float* sn = sh;
  float* smean = sh + kThreads;
  float* sm2 = sh + (1 + K) * kThreads;
  sn[me] = n;
#pragma unroll
  for (int i = 0; i < K; ++i) smean[i * kThreads + me] = mean[i], sm2[i * kThreads + me] = m2[i];
  for (int s = tree_top(t.rps); s >= 1; s >>= 1) {
    __syncthreads();
    if (t.r < s && t.r + s < t.rps) {
      const int o = me + s * t.cols;
      const float nb = sn[o];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float nc = n;  // every channel of the column has the same count
        chan_merge(nc, mean[i], m2[i], nb, smean[i * kThreads + o], sm2[i * kThreads + o]);
        smean[i * kThreads + me] = mean[i], sm2[i * kThreads + me] = m2[i];
      }
      n += nb;
      sn[me] = n;
    }
  }
}

// Up to U of the lane's rows r, r + rps, ... below r_end: each item's
// offset, x's raw item and, where dy is given, dy's; r advanced; returns
// how many. Every load is issued before any is used.
template <int VEC, int U>
__device__ __forceinline__ int load_rows(int& r, int r_end, const Tile& t, int C,
                                         const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ dy,
                                         typename Vec<VEC>::Raw (&rx)[U],
                                         typename Vec<VEC>::Raw (&rd)[U], long long (&at)[U]) {
  int k = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (r < r_end) {
      at[u] = (long long)r * C + (long long)t.j * VEC;
      rx[u] = Vec<VEC>::load(x + at[u]);
      if (dy != nullptr) rd[u] = Vec<VEC>::load(dy + at[u]);
      k = u + 1;
      r += t.rps;
    }
  }
  return k;
}

// part [2][chunks + 1][C]: row k < chunks of each half a chunk's partials,
// row chunks the backward's totals
__device__ __forceinline__ long long part_at(int half, int k, int chunks, int C, int c) {
  return ((long long)half * (chunks + 1) + k) * C + c;
}

// Per (chunk, channel): the chunk's Welford state (mean, M2), the lane's
// rows joined kRowsAtOnce at a time as in bn_fwd_stats_kernel, then the
// column's lanes merged.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_nhwc_fwd_stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ part, int R,
                         int C, int cols, int rows_per_chunk) {
  __shared__ float sh[(1 + 2 * VEC) * kThreads];
  const Tile t(cols, blockIdx.x, C / VEC);
  const int chunk = blockIdx.y, r_end = min(R, (chunk + 1) * rows_per_chunk);
  float n = 0.0f, mean[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = 0.0f, m2[i] = 0.0f;
  if (t.on) {
    int r = chunk * rows_per_chunk + t.r;
    while (r < r_end) {
      typename Vec<VEC>::Raw raw[kRowsAtOnce], unused[kRowsAtOnce];
      long long at[kRowsAtOnce];
      const int k = load_rows<VEC, kRowsAtOnce>(r, r_end, t, C, x, nullptr, raw, unused, at);
      if (n == 0.0f) Vec<VEC>::unpack(raw[0], mean);  // the first pivot
      float s1[VEC], s2[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) s1[i] = 0.0f, s2[i] = 0.0f;
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        if (u < k) {  // each item unpacked where it is used: registers for VEC channels
          float v[VEC];
          Vec<VEC>::unpack(raw[u], v);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float d = v[i] - mean[i];
            s1[i] += d;
            s2[i] = fmaf(d, d, s2[i]);
          }
        }
      }
      n += (float)k;
      const float rn = __frcp_rn(n);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        mean[i] = mean[i] + s1[i] * rn;
        m2[i] = m2[i] + (s2[i] - s1[i] * s1[i] * rn);
      }
    }
  }
  column_merge<VEC>(n, mean, m2, t, sh);
  if (t.on && t.r == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      part[part_at(0, chunk, gridDim.y, C, t.j * VEC + i)] = mean[i];
      part[part_at(1, chunk, gridDim.y, C, t.j * VEC + i)] = m2[i];
    }
  }
}

// A channel's chunk states merged in a fixed order (lane r takes chunks r,
// r + rps, ..., then the tree): the saved mean and invstd, the running
// update. Grid: ceil(C / kFinC) blocks.
__global__ void __launch_bounds__(kThreads)
bn_nhwc_fwd_finalize_kernel(const float* __restrict__ part, float* __restrict__ running_mean,
                            float* __restrict__ running_var, float* __restrict__ save_mean,
                            float* __restrict__ save_invstd, int R, int C, int rows_per_chunk,
                            int chunks, float eps, float m, float one_minus_m, float unbias) {
  __shared__ float sh[3 * kThreads];
  const Tile t(kFinC, blockIdx.x, C);
  float n = 0.0f, mean[1] = {0.0f}, m2[1] = {0.0f};
  if (t.on) {
    for (int k0 = t.r; k0 < chunks; k0 += kFinBatch * t.rps) {
      float pm[kFinBatch], pq[kFinBatch];  // every load in flight before the merges
#pragma unroll
      for (int u = 0; u < kFinBatch; ++u) {
        const int k = k0 + u * t.rps;
        if (k < chunks) {
          pm[u] = part[part_at(0, k, chunks, C, t.j)];
          pq[u] = part[part_at(1, k, chunks, C, t.j)];
        }
      }
#pragma unroll
      for (int u = 0; u < kFinBatch; ++u) {
        const int k = k0 + u * t.rps;
        if (k < chunks) {
          const int rows = min(R, (k + 1) * rows_per_chunk) - k * rows_per_chunk;
          chan_merge(n, mean[0], m2[0], (float)rows, pm[u], pq[u]);
        }
      }
    }
  }
  column_merge<1>(n, mean, m2, t, sh);
  if (!t.on || t.r != 0) return;
  float var = __fdiv_rn(m2[0], (float)R);
  if (var < 0.0f) var = 0.0f;  // M2 can round below 0; a NaN stays a NaN
  save_mean[t.j] = mean[0];
  save_invstd[t.j] = inv_std(var, eps);
  update_running(running_mean, running_var, t.j, mean[0], var, m, one_minus_m, unbias);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_nhwc_fwd_apply_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ weight,
                         const float* __restrict__ bias, const float* __restrict__ save_mean,
                         const float* __restrict__ save_invstd, __nv_bfloat16* __restrict__ y,
                         int R, int C, int cols, int rows_per_chunk) {
  // the reverse of bn_nhwc_fwd_stats_kernel's block order
  const Tile t(cols, gridDim.x - 1 - blockIdx.x, C / VEC);
  const int chunk = gridDim.y - 1 - blockIdx.y, r_end = min(R, (chunk + 1) * rows_per_chunk);
  if (!t.on) return;
  float mean[VEC], invstd[VEC], gamma[VEC], beta[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = t.j * VEC + i;
    mean[i] = save_mean[c], invstd[i] = save_invstd[c], gamma[i] = weight[c], beta[i] = bias[c];
  }
  int r = chunk * rows_per_chunk + t.r;
  while (r < r_end) {
    typename Vec<VEC>::Raw raw[kRowsAtOnce], unused[kRowsAtOnce];
    long long at[kRowsAtOnce];
    const int k = load_rows<VEC, kRowsAtOnce>(r, r_end, t, C, x, nullptr, raw, unused, at);
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      if (u < k) {
        float v[VEC];
        Vec<VEC>::unpack(raw[u], v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = normalize(v[i], mean[i], invstd[i], gamma[i], beta[i]);
        Vec<VEC>::store(y + at[u], v);
      }
    }
  }
}

// Per (chunk, channel): sum dy and sum dy * (x - mean) over the chunk's
// rows, the column's lanes summed in the tree.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_nhwc_bwd_reduce_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ dy,
                          const float* __restrict__ save_mean, float* __restrict__ part, int R,
                          int C, int cols, int rows_per_chunk) {
  __shared__ float sh[2 * VEC * kThreads];
  const Tile t(cols, blockIdx.x, C / VEC);
  const int chunk = blockIdx.y, r_end = min(R, (chunk + 1) * rows_per_chunk);
  float acc[2 * VEC];  // sum at [i], dot at [VEC + i]
#pragma unroll
  for (int i = 0; i < 2 * VEC; ++i) acc[i] = 0.0f;
  if (t.on) {
    float mean[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) mean[i] = save_mean[t.j * VEC + i];
    int r = chunk * rows_per_chunk + t.r;
    while (r < r_end) {
      typename Vec<VEC>::Raw rx[kRowsAtOnce], rd[kRowsAtOnce];
      long long at[kRowsAtOnce];
      const int k = load_rows<VEC, kRowsAtOnce>(r, r_end, t, C, x, dy, rx, rd, at);
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        if (u < k) {
          float vx[VEC], vd[VEC];
          Vec<VEC>::unpack(rx[u], vx);
          Vec<VEC>::unpack(rd[u], vd);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            acc[i] += vd[i];
            acc[VEC + i] = fmaf(vd[i], vx[i] - mean[i], acc[VEC + i]);
          }
        }
      }
    }
  }
  column_sum<2 * VEC>(acc, t, sh);
  if (t.on && t.r == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      part[part_at(0, chunk, gridDim.y, C, t.j * VEC + i)] = acc[i];
      part[part_at(1, chunk, gridDim.y, C, t.j * VEC + i)] = acc[VEC + i];
    }
  }
}

// A channel's chunk sums in a fixed order: dgamma, dbeta, and the totals
// (row chunks of part) that the dx pass reads. Grid: ceil(C / kFinC).
__global__ void __launch_bounds__(kThreads)
bn_nhwc_bwd_finalize_kernel(float* __restrict__ part, const float* __restrict__ save_invstd,
                            float* __restrict__ dweight, float* __restrict__ dbias, int C,
                            int chunks) {
  __shared__ float sh[2 * kThreads];
  const Tile t(kFinC, blockIdx.x, C);
  float acc[2] = {0.0f, 0.0f};
  if (t.on) {
    for (int k0 = t.r; k0 < chunks; k0 += kFinBatch * t.rps) {
      float ps[kFinBatch], pd[kFinBatch];  // every load in flight before the sums
#pragma unroll
      for (int u = 0; u < kFinBatch; ++u) {
        const int k = k0 + u * t.rps;
        if (k < chunks) {
          ps[u] = part[part_at(0, k, chunks, C, t.j)];
          pd[u] = part[part_at(1, k, chunks, C, t.j)];
        }
      }
#pragma unroll
      for (int u = 0; u < kFinBatch; ++u) {
        if (k0 + u * t.rps < chunks) acc[0] += ps[u], acc[1] += pd[u];
      }
    }
  }
  column_sum<2>(acc, t, sh);
  if (!t.on || t.r != 0) return;
  dweight[t.j] = __fmul_rn(acc[1], save_invstd[t.j]);
  dbias[t.j] = acc[0];
  part[part_at(0, chunks, chunks, C, t.j)] = acc[0];
  part[part_at(1, chunks, chunks, C, t.j)] = acc[1];
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
bn_nhwc_bwd_dx_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                      const float* __restrict__ part, const float* __restrict__ weight,
                      const float* __restrict__ save_mean, const float* __restrict__ save_invstd,
                      __nv_bfloat16* __restrict__ dx, int R, int C, int cols,
                      int rows_per_chunk) {
  // the reverse of the reduce's block order
  const Tile t(cols, gridDim.x - 1 - blockIdx.x, C / VEC);
  const int chunks = gridDim.y, chunk = chunks - 1 - blockIdx.y;
  const int r_end = min(R, (chunk + 1) * rows_per_chunk);
  if (!t.on) return;
  Grad g[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = t.j * VEC + i;
    g[i] = Grad(part[part_at(0, chunks, chunks, C, c)], part[part_at(1, chunks, chunks, C, c)],
                (float)R, save_mean[c], save_invstd[c], weight[c]);
  }
  int r = chunk * rows_per_chunk + t.r;
  while (r < r_end) {
    typename Vec<VEC>::Raw rx[kRowsAtOnce], rd[kRowsAtOnce];
    long long at[kRowsAtOnce];
    const int k = load_rows<VEC, kRowsAtOnce>(r, r_end, t, C, x, dy, rx, rd, at);
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      if (u < k) {
        float vx[VEC], vd[VEC];
        Vec<VEC>::unpack(rx[u], vx);
        Vec<VEC>::unpack(rd[u], vd);
#pragma unroll
        for (int i = 0; i < VEC; ++i) vx[i] = g[i].dx(vx[i], vd[i]);
        Vec<VEC>::store(dx + at[u], vx);
      }
    }
  }
}

// One pass: a cluster of kCluster blocks a column tile, on as many SMs;
// block q of the cluster holds rows [q * rpb, (q + 1) * rpb) of its
// columns, at most kHeldRows a lane. A column's sums: the lanes' in the
// block's tree (column_sum), then the cluster's blocks' in rank order,
// read from their shared memory: the same bits in every block, no atomics.
// (One exchange of Welford states instead of two of sums, or each lane of
// a column reading one rank, measured slower on an H100: PERF.md.)

struct ClusterRows {  // the rows of the block of rank q
  int begin, end;
  __device__ __forceinline__ ClusterRows(int R, int rows_per_block, int rank)
      : begin(min(R, rank * rows_per_block)), end(min(R, (rank + 1) * rows_per_block)) {}
};

// v[K] (a block's column totals, as column_sum leaves them in sh and in
// every lane) summed over the cluster's blocks in rank order, into every
// lane of the column. xch: K * kThreads floats. Every thread of every
// block of the cluster calls it; the second barrier keeps every block
// (and its sh) until the others have read it.
template <int K>
__device__ __forceinline__ void cluster_column_sum(float (&v)[K], const Tile& t, float* sh,
                                                   float* xch) {
  cg::cluster_group cluster = cg::this_cluster();
  const int jl = (int)threadIdx.x % t.cols;
  cluster.sync();  // every block's totals are in its sh (column_sum's row-0 slots)
  if (t.r == 0) {
    float s[K];
#pragma unroll
    for (int i = 0; i < K; ++i) s[i] = 0.0f;
    for (int b = 0; b < kCluster; ++b) {
      const float* remote = cluster.map_shared_rank(sh, b);
#pragma unroll
      for (int i = 0; i < K; ++i) s[i] += remote[i * kThreads + jl];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) xch[i * kThreads + jl] = s[i];
  }
  cluster.sync();  // the remote reads are done (sh is free again) and xch is written
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = xch[i * kThreads + jl];
}

// The lane's items of the block's rows, at most U, loaded at once
template <int VEC, int U>
__device__ __forceinline__ int hold_block_rows(const ClusterRows& rows, const Tile& t, int C,
                                               const __nv_bfloat16* __restrict__ x,
                                               const __nv_bfloat16* __restrict__ dy,
                                               typename Vec<VEC>::Raw (&rx)[U],
                                               typename Vec<VEC>::Raw (&rd)[U]) {
  int k = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = rows.begin + t.r + u * t.rps;
    if (t.on && r < rows.end) {
      const long long at = (long long)r * C + (long long)t.j * VEC;
      rx[u] = Vec<VEC>::load(x + at);
      if (dy != nullptr) rd[u] = Vec<VEC>::load(dy + at);
      k = u + 1;
    }
  }
  return k;
}

__device__ __forceinline__ long long block_row_at(int u, const ClusterRows& rows, const Tile& t,
                                                  int C, int VEC) {
  return (long long)(rows.begin + t.r + u * t.rps) * C + (long long)t.j * VEC;
}

// Mean and variance in two exact passes over the registers, as
// bn_fwd_fused_kernel. Grid: (column tiles * kCluster).
template <int VEC>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
bn_nhwc_fwd_fused_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ weight,
                         const float* __restrict__ bias, float* __restrict__ running_mean,
                         float* __restrict__ running_var, __nv_bfloat16* __restrict__ y,
                         float* __restrict__ save_mean, float* __restrict__ save_invstd, int R,
                         int C, int cols, int rows_per_block, float eps, float m,
                         float one_minus_m, float unbias) {
  __shared__ float sh[VEC * kThreads], xch[VEC * kThreads];
  const int rank = (int)cg::this_cluster().block_rank();
  const Tile t(cols, blockIdx.x / kCluster, C / VEC);
  const ClusterRows rows(R, rows_per_block, rank);
  typename Vec<VEC>::Raw raw[kHeldRows], unused[kHeldRows];
  const int k = hold_block_rows<VEC, kHeldRows>(rows, t, C, x, nullptr, raw, unused);
  const float n = (float)R;
  float mean[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = 0.0f;
#pragma unroll
  for (int u = 0; u < kHeldRows; ++u) {
    if (u < k) {
      float v[VEC];
      Vec<VEC>::unpack(raw[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) mean[i] += v[i];
    }
  }
  column_sum<VEC>(mean, t, sh);
  cluster_column_sum<VEC>(mean, t, sh, xch);
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = __fdiv_rn(mean[i], n);
  float var[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) var[i] = 0.0f;
#pragma unroll
  for (int u = 0; u < kHeldRows; ++u) {
    if (u < k) {
      float v[VEC];
      Vec<VEC>::unpack(raw[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[i] - mean[i];
        var[i] = fmaf(d, d, var[i]);
      }
    }
  }
  column_sum<VEC>(var, t, sh);
  cluster_column_sum<VEC>(var, t, sh, xch);
  if (!t.on) return;  // no block- or cluster-wide step follows
  float invstd[VEC], gamma[VEC], beta[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = t.j * VEC + i;
    var[i] = __fdiv_rn(var[i], n);
    invstd[i] = inv_std(var[i], eps);
    gamma[i] = weight[c], beta[i] = bias[c];
    if (rank == 0 && t.r == 0) {
      save_mean[c] = mean[i];
      save_invstd[c] = invstd[i];
      update_running(running_mean, running_var, c, mean[i], var[i], m, one_minus_m, unbias);
    }
  }
#pragma unroll
  for (int u = 0; u < kHeldRows; ++u) {
    if (u < k) {
      float v[VEC];
      Vec<VEC>::unpack(raw[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = normalize(v[i], mean[i], invstd[i], gamma[i], beta[i]);
      Vec<VEC>::store(y + block_row_at(u, rows, t, C, VEC), v);
    }
  }
}

template <int VEC>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
bn_nhwc_bwd_fused_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ dy, const float* __restrict__ weight,
                         const float* __restrict__ save_mean,
                         const float* __restrict__ save_invstd, __nv_bfloat16* __restrict__ dx,
                         float* __restrict__ dweight, float* __restrict__ dbias, int R, int C,
                         int cols, int rows_per_block) {
  __shared__ float sh[2 * VEC * kThreads], xch[2 * VEC * kThreads];
  const int rank = (int)cg::this_cluster().block_rank();
  const Tile t(cols, blockIdx.x / kCluster, C / VEC);
  const ClusterRows rows(R, rows_per_block, rank);
  typename Vec<VEC>::Raw rx[kHeldRows], rd[kHeldRows];
  const int k = hold_block_rows<VEC, kHeldRows>(rows, t, C, x, dy, rx, rd);
  float mean[VEC], acc[2 * VEC];  // sum at [i], dot at [VEC + i]
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    mean[i] = t.on ? save_mean[t.j * VEC + i] : 0.0f, acc[i] = 0.0f, acc[VEC + i] = 0.0f;
#pragma unroll
  for (int u = 0; u < kHeldRows; ++u) {
    if (u < k) {
      float vx[VEC], vd[VEC];
      Vec<VEC>::unpack(rx[u], vx);
      Vec<VEC>::unpack(rd[u], vd);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        acc[i] += vd[i];
        acc[VEC + i] = fmaf(vd[i], vx[i] - mean[i], acc[VEC + i]);
      }
    }
  }
  column_sum<2 * VEC>(acc, t, sh);
  cluster_column_sum<2 * VEC>(acc, t, sh, xch);
  if (!t.on) return;  // no block- or cluster-wide step follows
  Grad g[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = t.j * VEC + i;
    const float invstd = save_invstd[c];
    if (rank == 0 && t.r == 0) {
      dweight[c] = __fmul_rn(acc[VEC + i], invstd);
      dbias[c] = acc[i];
    }
    g[i] = Grad(acc[i], acc[VEC + i], (float)R, mean[i], invstd, weight[c]);
  }
#pragma unroll
  for (int u = 0; u < kHeldRows; ++u) {
    if (u < k) {
      float vx[VEC], vd[VEC];
      Vec<VEC>::unpack(rx[u], vx);
      Vec<VEC>::unpack(rd[u], vd);
#pragma unroll
      for (int i = 0; i < VEC; ++i) vx[i] = g[i].dx(vx[i], vd[i]);
      Vec<VEC>::store(dx + block_row_at(u, rows, t, C, VEC), vx);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

// The shape and plan a launch takes (ops/cuda_batchnorm.bn_plan makes the
// plan): vec 8 needs S % 8 == 0 and 16-byte rows; tpc a power of two, at
// most 32 in the two-pass kernels; the one-pass kernels hold at most kHeld
// items a lane; the two-pass grid's chunks fit its y dimension.
bool bad_plan(int N, int C, int S, int vec, int tpc, int b_per_chunk, int fused) {
  if (N < 1 || C < 1 || S < 1 || (vec != 1 && vec != 8) || S % vec != 0) return true;
  if (tpc < 1 || tpc > kThreads || (tpc & (tpc - 1)) != 0) return true;
  const long long items = (long long)N * (S / vec);
  if (fused) return (items + tpc - 1) / tpc > kHeld;
  return tpc > 32 || b_per_chunk < 1 || (N + b_per_chunk - 1) / b_per_chunk > 65535;
}

template <int VEC>
int launch_fwd(const __nv_bfloat16* x, const float* weight, const float* bias, float* rm,
               float* rv, __nv_bfloat16* y, float* save_mean, float* save_invstd, float* part,
               int N, int C, int S, int tpc, int b_per_chunk, int fused, float eps, float m,
               float one_minus_m, float unbias, cudaStream_t stream) {
  const int groups = (C + kThreads / tpc - 1) / (kThreads / tpc);
  if (fused) {
    bn_fwd_fused_kernel<VEC><<<groups, kThreads, 0, stream>>>(
        x, weight, bias, rm, rv, y, save_mean, save_invstd, N, C, S, tpc, eps, m, one_minus_m,
        unbias);
    return (int)cudaGetLastError();
  }
  const dim3 grid(groups, (N + b_per_chunk - 1) / b_per_chunk);
  bn_fwd_stats_kernel<VEC><<<grid, kThreads, 0, stream>>>(x, part, N, C, S, tpc, b_per_chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_fwd_apply_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      x, part, weight, bias, rm, rv, y, save_mean, save_invstd, N, C, S, tpc, b_per_chunk, eps,
      m, one_minus_m, unbias);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_bwd(const __nv_bfloat16* x, const __nv_bfloat16* dy, const float* weight,
               const float* save_mean, const float* save_invstd, __nv_bfloat16* dx,
               float* dweight, float* dbias, float* part, int N, int C, int S, int tpc,
               int b_per_chunk, int fused, cudaStream_t stream) {
  const int groups = (C + kThreads / tpc - 1) / (kThreads / tpc);
  if (fused) {
    bn_bwd_fused_kernel<VEC><<<groups, kThreads, 0, stream>>>(
        x, dy, weight, save_mean, save_invstd, dx, dweight, dbias, N, C, S, tpc);
    return (int)cudaGetLastError();
  }
  const dim3 grid(groups, (N + b_per_chunk - 1) / b_per_chunk);
  bn_bwd_reduce_kernel<VEC><<<grid, kThreads, 0, stream>>>(x, dy, save_mean, part, N, C, S, tpc,
                                                           b_per_chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_bwd_dx_kernel<VEC><<<grid, kThreads, 0, stream>>>(x, dy, part, weight, save_mean,
                                                       save_invstd, dx, dweight, dbias, N, C,
                                                       S, tpc, b_per_chunk);
  return (int)cudaGetLastError();
}

// The channels-innermost plan (ops/cuda_batchnorm.bn_plan_nhwc): vec 8
// needs C % 8 == 0 and 16-byte rows; cols columns a block, at most
// kThreads; R cut into chunks of rows_per_chunk rows: one pass, kCluster
// chunks (a cluster's blocks) of at most kHeldRows rows a lane; two passes,
// chunks that fit the grid's y dimension.
bool bad_plan_nhwc(int R, int C, int vec, int cols, int rows_per_chunk, int chunks, int fused) {
  if (R < 1 || C < 1 || (vec != 1 && vec != 8) || C % vec != 0) return true;
  if (cols < 1 || cols > kThreads || cols > C / vec || rows_per_chunk < 1) return true;
  const int rps = kThreads / cols;
  if (fused)
    return chunks != kCluster || rows_per_chunk != (R + kCluster - 1) / kCluster ||
           (rows_per_chunk + rps - 1) / rps > kHeldRows;
  return chunks != (R + rows_per_chunk - 1) / rows_per_chunk || chunks > 65535;
}

template <int VEC>
int launch_fwd_nhwc(const __nv_bfloat16* x, const float* weight, const float* bias, float* rm,
                    float* rv, __nv_bfloat16* y, float* save_mean, float* save_invstd,
                    float* part, int R, int C, int cols, int rows_per_chunk, int chunks,
                    int fused, float eps, float m, float one_minus_m, float unbias,
                    cudaStream_t stream) {
  const int tiles = (C / VEC + cols - 1) / cols;
  if (fused) {
    bn_nhwc_fwd_fused_kernel<VEC><<<tiles * kCluster, kThreads, 0, stream>>>(
        x, weight, bias, rm, rv, y, save_mean, save_invstd, R, C, cols, rows_per_chunk, eps, m,
        one_minus_m, unbias);
    return (int)cudaGetLastError();
  }
  const dim3 grid(tiles, chunks);
  bn_nhwc_fwd_stats_kernel<VEC><<<grid, kThreads, 0, stream>>>(x, part, R, C, cols,
                                                               rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_nhwc_fwd_finalize_kernel<<<(C + kFinC - 1) / kFinC, kThreads, 0, stream>>>(
      part, rm, rv, save_mean, save_invstd, R, C, rows_per_chunk, chunks, eps, m, one_minus_m,
      unbias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_nhwc_fwd_apply_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      x, weight, bias, save_mean, save_invstd, y, R, C, cols, rows_per_chunk);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_bwd_nhwc(const __nv_bfloat16* x, const __nv_bfloat16* dy, const float* weight,
                    const float* save_mean, const float* save_invstd, __nv_bfloat16* dx,
                    float* dweight, float* dbias, float* part, int R, int C, int cols,
                    int rows_per_chunk, int chunks, int fused, cudaStream_t stream) {
  const int tiles = (C / VEC + cols - 1) / cols;
  if (fused) {
    bn_nhwc_bwd_fused_kernel<VEC><<<tiles * kCluster, kThreads, 0, stream>>>(
        x, dy, weight, save_mean, save_invstd, dx, dweight, dbias, R, C, cols, rows_per_chunk);
    return (int)cudaGetLastError();
  }
  const dim3 grid(tiles, chunks);
  bn_nhwc_bwd_reduce_kernel<VEC><<<grid, kThreads, 0, stream>>>(x, dy, save_mean, part, R, C,
                                                                cols, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_nhwc_bwd_finalize_kernel<<<(C + kFinC - 1) / kFinC, kThreads, 0, stream>>>(
      part, save_invstd, dweight, dbias, C, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_nhwc_bwd_dx_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      x, dy, part, weight, save_mean, save_invstd, dx, R, C, cols, rows_per_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points: x, y, dy, dx bfloat16 [N, C, S] contiguous; weight, bias,
// the running buffers, the saved statistics and the gradients of weight
// and bias float32 [C]; part float32 [2, chunks, C] for the two-pass
// kernels (unused, may be null, for the one-pass ones). vec, tpc,
// b_per_chunk and fused: the plan of ops/cuda_batchnorm.bn_plan. Each
// returns a cudaError_t as int: 0 on success, the first launch's error
// otherwise.
// ---------------------------------------------------------------------------

// The forward: y, the saved mean and invstd, and the running update in
// place (r <- one_minus_m * r + m * stat, the variance times
// unbias = n / (n - 1))
extern "C" int bn_fwd(const void* x, const float* weight, const float* bias, float* running_mean,
                      float* running_var, void* y, float* save_mean, float* save_invstd,
                      float* part, int N, int C, int S, int vec, int tpc, int b_per_chunk,
                      int fused, float eps, float m, float one_minus_m, float unbias,
                      cudaStream_t stream) {
  if (bad_plan(N, C, S, vec, tpc, b_per_chunk, fused) || (!fused && part == nullptr) ||
      (vec == 8 && !(aligned(x) && aligned(y))))
    return (int)cudaErrorInvalidValue;
  const auto* xb = (const __nv_bfloat16*)x;
  auto* yb = (__nv_bfloat16*)y;
  if (vec == 8)
    return launch_fwd<8>(xb, weight, bias, running_mean, running_var, yb, save_mean, save_invstd,
                         part, N, C, S, tpc, b_per_chunk, fused, eps, m, one_minus_m, unbias,
                         stream);
  return launch_fwd<1>(xb, weight, bias, running_mean, running_var, yb, save_mean, save_invstd,
                       part, N, C, S, tpc, b_per_chunk, fused, eps, m, one_minus_m, unbias,
                       stream);
}

// The backward: dx, and the gradients of weight and bias
extern "C" int bn_bwd(const void* x, const void* dy, const float* weight, const float* save_mean,
                      const float* save_invstd, void* dx, float* dweight, float* dbias,
                      float* part, int N, int C, int S, int vec, int tpc, int b_per_chunk,
                      int fused, cudaStream_t stream) {
  if (bad_plan(N, C, S, vec, tpc, b_per_chunk, fused) || (!fused && part == nullptr) ||
      (vec == 8 && !(aligned(x) && aligned(dy) && aligned(dx))))
    return (int)cudaErrorInvalidValue;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* db = (const __nv_bfloat16*)dy;
  auto* dxb = (__nv_bfloat16*)dx;
  if (vec == 8)
    return launch_bwd<8>(xb, db, weight, save_mean, save_invstd, dxb, dweight, dbias, part, N, C,
                         S, tpc, b_per_chunk, fused, stream);
  return launch_bwd<1>(xb, db, weight, save_mean, save_invstd, dxb, dweight, dbias, part, N, C,
                       S, tpc, b_per_chunk, fused, stream);
}

// The channels-innermost entry points: x, y, dy, dx bfloat16 [R, C]
// row-major (a channels-last [N, C, H, W] tensor, R = N * H * W); the
// channel vectors as above; part float32 [2, chunks + 1, C] for the
// two-pass kernels (unused, may be null, for the one-pass ones). vec, cols,
// rows_per_chunk, chunks and fused: the plan of
// ops/cuda_batchnorm.bn_plan_nhwc. The same returns as bn_fwd and bn_bwd.

extern "C" int bn_fwd_nhwc(const void* x, const float* weight, const float* bias,
                           float* running_mean, float* running_var, void* y, float* save_mean,
                           float* save_invstd, float* part, int R, int C, int vec, int cols,
                           int rows_per_chunk, int chunks, int fused, float eps, float m,
                           float one_minus_m, float unbias, cudaStream_t stream) {
  if (bad_plan_nhwc(R, C, vec, cols, rows_per_chunk, chunks, fused) ||
      (!fused && part == nullptr) || (vec == 8 && !(aligned(x) && aligned(y))))
    return (int)cudaErrorInvalidValue;
  const auto* xb = (const __nv_bfloat16*)x;
  auto* yb = (__nv_bfloat16*)y;
  if (vec == 8)
    return launch_fwd_nhwc<8>(xb, weight, bias, running_mean, running_var, yb, save_mean,
                              save_invstd, part, R, C, cols, rows_per_chunk, chunks, fused, eps,
                              m, one_minus_m, unbias, stream);
  return launch_fwd_nhwc<1>(xb, weight, bias, running_mean, running_var, yb, save_mean,
                            save_invstd, part, R, C, cols, rows_per_chunk, chunks, fused, eps, m,
                            one_minus_m, unbias, stream);
}

extern "C" int bn_bwd_nhwc(const void* x, const void* dy, const float* weight,
                           const float* save_mean, const float* save_invstd, void* dx,
                           float* dweight, float* dbias, float* part, int R, int C, int vec,
                           int cols, int rows_per_chunk, int chunks, int fused,
                           cudaStream_t stream) {
  if (bad_plan_nhwc(R, C, vec, cols, rows_per_chunk, chunks, fused) ||
      (!fused && part == nullptr) || (vec == 8 && !(aligned(x) && aligned(dy) && aligned(dx))))
    return (int)cudaErrorInvalidValue;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* db = (const __nv_bfloat16*)dy;
  auto* dxb = (__nv_bfloat16*)dx;
  if (vec == 8)
    return launch_bwd_nhwc<8>(xb, db, weight, save_mean, save_invstd, dxb, dweight, dbias, part,
                              R, C, cols, rows_per_chunk, chunks, fused, stream);
  return launch_bwd_nhwc<1>(xb, db, weight, save_mean, save_invstd, dxb, dweight, dbias, part, R,
                            C, cols, rows_per_chunk, chunks, fused, stream);
}
