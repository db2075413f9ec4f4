// Fused train-mode BatchNorm -> ReLU -> 1x1 conv, forward and backward, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel`, `_bwd_reduce_kernel` and
// `_bwd_dx_kernel` of mopoe_mimic_tpu/ops/pallas_pointwise.py (:81, :88,
// :119), launched by `_core_fwd` (:161) and `_core_bwd` (:193, :220). For a
// residual block's input x [B, C, S] (float32 or bfloat16: the port's NCHW /
// NCL layout with the spatial axes flattened, rows n = (b, s), R = B * S),
// the batch statistics mean and inv = 1 / sqrt(var + eps) [C], gamma, beta [C]
// and the conv bias cb [Co] (float32), and the 1x1 conv's matrix W [C, Co]
// in the compute dtype T (float32 or bfloat16):
//
//   xhat = (x - mean) * inv,  h = relu(gamma * xhat + beta)          (float32)
//   y[b, o, s] = sum_c W[c, o] * round_T(h[b, c, s]) + cb[o]          (float32 sums, y in T)
//
// and, from dy [B, Co, S] in T,
//
//   dh = (W . dy) * 1[h > 0]                                          (float32)
//   pass A: dW = sum_n round_T(h) dy^T,  dcb = sum_n dy,
//           dgamma = sum_n dh * xhat,  dbeta = sum_n dh               (float32)
//   pass B: dx = gamma * inv * (dh - dbeta / R - xhat * dgamma / R)   (x's dtype)
//
// xhat and h are recomputed from x in every kernel and never stored. The
// batch statistics mean and inv, and bn1's running update, come from
// pointwise_stats (partials per chunk of rows) and pointwise_stats_finalize
// (section "pointwise_stats" below), for both families.
//
// What bounds it on this card: the products are 2 * R * C * Co operations
// over R * (C + Co) elements, 64-320 operations per element read, so in
// bf16 on tensor cores (~295 operations per byte of HBM) the bytes bound
// them: a kernel has to stream x and dy once at the memory's rate and keep
// the products and the normalisation out of the way.
//
// Two families of kernels:
//
//  * bfloat16 W (the bf16 autocast of training): pointwise_fwd_tc,
//    pointwise_bwd_reduce_tc (pass A) and pointwise_bwd_dx_tc (pass B) run
//    the products on tensor cores (mma.sync from ldmatrix, float32 sums)
//    and stream x and dy with 16-byte cp.async copies, three units of 64
//    rows x 64 channels in flight; the section "bfloat16 on tensor cores"
//    below says how.
//  * float32 W: pointwise_fwd, pointwise_bwd_reduce and pointwise_bwd_dx
//    run the products as float32 FMAs on the CUDA cores (TF32 would change
//    the numbers), fed from shared memory:
//    - No permutation to rows x C: the kernels index [B, C, S] directly. A
//      row tile's loads and stores run along s, contiguous where S >= 16;
//      the row offset b * K * S + s is computed once per tile.
//    - 256 threads as 16 x 16, each with a 4 x 8 (forward, pass B) or 4 x 4
//      (pass A) micro-tile of sums in registers. Operand tiles are staged
//      in shared memory as float, rows padded by one float, so that
//      row-wise and transposed reads both fall in distinct banks. C and Co
//      (up to 320 at the flagship) are tiled.
//    - pointwise_fwd: one block per (128 rows, 64 outputs), looping over
//      the channels in chunks of 32; pointwise_bwd_dx: one block per (128
//      rows, 64 channels), looping over the outputs in chunks of 32; the
//      epilogue reloads x for xhat and the mask.
//
// Pass A in both families: the TPU carries its sums across a sequential
// grid in VMEM; blocks here run in no order. Each block takes one (row
// chunk, 64 channels, 64 outputs) tile and writes its partial sums, and
// pointwise_bwd_finalize sums each output's partials in a fixed order. No
// atomics: two runs give equal gradients. dh over one output tile is a
// partial of the full dh; the mask and the sums after it are linear in dh,
// so dgamma and dbeta are summed over output tiles as well, and each
// product is computed once. Long sums: each 64-row unit's partial joins the
// block's running sums by compensated (Kahan) addition, and the finalize
// sums the chunks the same way (a float32 running sum over 32768 rows lost
// ~1e-4 in K2; here rows reach 2^20). xhat and gamma * xhat + beta round
// each operation on its own (__fmul_rn, __fadd_rn: no FMA contraction), as
// PyTorch's elementwise ops do, so h and its bf16 rounding equal the plain
// version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "welford.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kMaxC = 2048;
// forward and pass B: tiles of 64 outputs / channels x 128 rows, depth chunks of 32
constexpr int FP = 64, FN = 128, FK = 32;
// pass A: 64 channels x 64 outputs, sub-tiles of 64 rows; shared rows padded to 65
constexpr int AT = 64, AL = AT + 1;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a dtype cast does
}

// v rounded to T's precision and read back as float
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f<T>(from_f<T>(v)); }

struct Norm {
  const float* gamma;
  const float* beta;
  const float* mean;
  const float* inv;
};

__device__ __forceinline__ float norm_xhat(float x, const Norm& p, int c) {
  return __fmul_rn(__fsub_rn(x, __ldg(p.mean + c)), __ldg(p.inv + c));
}

// gamma * xhat + beta; h = relu of it, and h > 0 exactly where this is > 0
__device__ __forceinline__ float norm_pre(float xhat, float gamma, float beta) {
  return __fadd_rn(__fmul_rn(gamma, xhat), beta);
}

__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }  // NaN stays

// sum += v with the running compensation comp (Kahan); no fast-math, so the
// compiler keeps the order
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = v - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// offset of (row n, channel 0) in a [B, K, S] tensor
__device__ __forceinline__ long long row_base(int n, int K, int S) {
  const int b = n / S;
  return (long long)b * K * S + (n - b * S);
}

// acc[i][j] += sum_{k < K} A(k, ty * RP + i) * B(k, tx + 16 * j), with
// A(k, p) = a[k * a_k + p * a_p] and B(k, q) = b[k * b_k + q * b_q] in shared memory
template <int RP, int RQ, int K>
__device__ __forceinline__ void tile_fma(const float* a, int a_k, int a_p, const float* b,
                                         int b_k, int b_q, int ty, int tx,
                                         float (&acc)[RP][RQ]) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float av[RP], bv[RQ];
#pragma unroll
    for (int i = 0; i < RP; ++i) av[i] = a[k * a_k + (ty * RP + i) * a_p];
#pragma unroll
    for (int j = 0; j < RQ; ++j) bv[j] = b[k * b_k + (tx + 16 * j) * b_q];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename TX>
__global__ void __launch_bounds__(kThreads)
pointwise_fwd_kernel(const TX* __restrict__ x, Norm p, const float* __restrict__ W,
                     const float* __restrict__ cb, float* __restrict__ y, int R, int C, int Co,
                     int S) {
  __shared__ float ws[FK * (FP + 1)];  // ws[k][pp] = W[c0 + k, o0 + pp]
  __shared__ float hs[FK * (FN + 1)];  // hs[k][q] = h of row n0 + q, channel c0 + k
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * FN, o0 = blockIdx.y * FP;
  const int q = tid % FN;  // the row this thread stages
  const long long xrow = (n0 + q < R) ? row_base(n0 + q, C, S) : -1;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += FK) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < FK * FP; idx += kThreads) {
      const int k = idx / FP, pp = idx - k * FP, c = c0 + k, o = o0 + pp;
      ws[k * (FP + 1) + pp] = (c < C && o < Co) ? W[(long long)c * Co + o] : 0.0f;
    }
    for (int k = tid / FN; k < FK; k += kThreads / FN) {
      const int c = c0 + k;
      float h = 0.0f;
      if (c < C && xrow >= 0) {
        const float xh = norm_xhat(to_f<TX>(x[xrow + (long long)c * S]), p, c);
        h = relu(norm_pre(xh, __ldg(p.gamma + c), __ldg(p.beta + c)));
      }
      hs[k * (FN + 1) + q] = h;
    }
    __syncthreads();
    tile_fma<4, 8, FK>(ws, FP + 1, 1, hs, FN + 1, 1, ty, tx, acc);
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= R) continue;
    const long long yrow = row_base(n, Co, S);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = o0 + ty * 4 + i;
      if (o < Co) y[yrow + (long long)o * S] = acc[i][j] + __ldg(cb + o);
    }
  }
}

// ---------------------------------------------------------------------------
// backward pass B: dx
// ---------------------------------------------------------------------------

template <typename TX>
__global__ void __launch_bounds__(kThreads)
pointwise_bwd_dx_kernel(const TX* __restrict__ x, Norm p, const float* __restrict__ W,
                        const float* __restrict__ dy, const float* __restrict__ dg,
                        const float* __restrict__ db, TX* __restrict__ dx, int R, int C, int Co,
                        int S) {
  __shared__ float ws[FK * (FP + 1)];  // ws[k][pp] = W[c0 + pp, o0 + k]
  __shared__ float ds[FK * (FN + 1)];  // ds[k][q] = dy of row n0 + q, output o0 + k
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = blockIdx.x * FN, c0 = blockIdx.y * FP;
  const int q = tid % FN;
  const long long dyrow = (n0 + q < R) ? row_base(n0 + q, Co, S) : -1;

  float acc[4][8];  // dh of channels c0 + ty * 4 + i, rows n0 + tx + 16 * j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int o0 = 0; o0 < Co; o0 += FK) {
    __syncthreads();
    for (int idx = tid; idx < FK * FP; idx += kThreads) {
      const int k = idx / FP, pp = idx - k * FP, c = c0 + pp, o = o0 + k;
      ws[k * (FP + 1) + pp] = (c < C && o < Co) ? W[(long long)c * Co + o] : 0.0f;
    }
    for (int k = tid / FN; k < FK; k += kThreads / FN) {
      const int o = o0 + k;
      ds[k * (FN + 1) + q] =
          (o < Co && dyrow >= 0) ? dy[dyrow + (long long)o * S] : 0.0f;
    }
    __syncthreads();
    tile_fma<4, 8, FK>(ws, FP + 1, 1, ds, FN + 1, 1, ty, tx, acc);
  }

  const float rows = (float)R;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= R) continue;
    const long long xrow = row_base(n, C, S);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + ty * 4 + i;
      if (c >= C) continue;
      const long long at = xrow + (long long)c * S;
      const float xh = norm_xhat(to_f<TX>(x[at]), p, c);
      const float g = __ldg(p.gamma + c);
      const float d = norm_pre(xh, g, __ldg(p.beta + c)) > 0.0f ? acc[i][j] : 0.0f;
      const float v = (g * __ldg(p.inv + c)) *
                      ((d - __ldg(db + c) / rows) - (xh * __ldg(dg + c)) / rows);
      dx[at] = from_f<TX>(v);
    }
  }
}

// ---------------------------------------------------------------------------
// backward pass A: partial sums of dW, dcb, dgamma, dbeta per row chunk
// ---------------------------------------------------------------------------

template <typename TX>
__global__ void __launch_bounds__(kThreads)
pointwise_bwd_reduce_kernel(const TX* __restrict__ x, Norm p, const float* __restrict__ W,
                            const float* __restrict__ dy, float* __restrict__ part_dw,
                            float* __restrict__ part_dcb, float* __restrict__ part_dg,
                            float* __restrict__ part_db, int R, int C, int Co, int S,
                            int chunk_rows) {
  extern __shared__ float smem[];
  float* ws = smem;  // ws[o][c] = W[c0 + c, o0 + o]
  float* xs = ws + AT * AL;  // xs[n][c] = xhat
  float* hs = xs + AT * AL;  // hs[n][c] = h
  float* ds = hs + AT * AL;  // ds[n][o] = dy
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int chunk = blockIdx.x, c0 = blockIdx.y * AT, o0 = blockIdx.z * AT;
  const int n_begin = chunk * chunk_rows;
  const int n_end = min(R, n_begin + chunk_rows);

  for (int idx = tid; idx < AT * AT; idx += kThreads) {
    const int o = idx / AT, c = idx - o * AT;
    ws[o * AL + c] = (c0 + c < C && o0 + o < Co)
                         ? W[(long long)(c0 + c) * Co + o0 + o] : 0.0f;
  }
  // this thread's channels c0 + ty * 4 + i (zero past C: their mask is off)
  float gam[4], bet[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    gam[i] = (c < C) ? __ldg(p.gamma + c) : 0.0f;
    bet[i] = (c < C) ? __ldg(p.beta + c) : 0.0f;
  }
  // dW[c0 + ty * 4 + i, o0 + tx + 16 * j] with its compensation; dgamma,
  // dbeta of the thread's channels over its rows; dcb of output o0 + tid
  // (threads tid < 64 of the first channel tile)
  float dw[4][4], dw_c[4][4], dgs[4], dbs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dgs[i] = dbs[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) dw[i][j] = dw_c[i][j] = 0.0f;
  }
  float dcb = 0.0f, dcb_c = 0.0f;
  const int q = tid % AT;  // the row this thread stages

  for (int n0 = n_begin; n0 < n_end; n0 += AT) {
    const bool row_ok = n0 + q < n_end;
    const long long xrow = row_ok ? row_base(n0 + q, C, S) : -1;
    const long long dyrow = row_ok ? row_base(n0 + q, Co, S) : -1;
    __syncthreads();  // the previous sub-tile's readers are done; ws is written
    for (int k = tid / AT; k < AT; k += kThreads / AT) {
      const int c = c0 + k, o = o0 + k;
      float xh = 0.0f, h = 0.0f;
      if (c < C && row_ok) {
        xh = norm_xhat(to_f<TX>(x[xrow + (long long)c * S]), p, c);
        h = relu(norm_pre(xh, __ldg(p.gamma + c), __ldg(p.beta + c)));
      }
      xs[q * AL + k] = xh;
      hs[q * AL + k] = h;
      ds[q * AL + k] = (o < Co && row_ok) ? dy[dyrow + (long long)o * S] : 0.0f;
    }
    __syncthreads();

    // dW[c, o] += sum_n h[n, c] dy[n, o]
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
    tile_fma<4, 4, AT>(hs, AL, 1, ds, AL, 1, ty, tx, part);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) kahan_add(dw[i][j], dw_c[i][j], part[i][j]);

    // dh[c, n] over this output tile = sum_o W[c, o] dy[n, o], channels
    // ty * 4 + i, rows tx + 16 * j; then the mask and the dgamma, dbeta sums
    float dh[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dh[i][j] = 0.0f;
    tile_fma<4, 4, AT>(ws, AL, 1, ds, 1, AL, ty, tx, dh);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xh = xs[(tx + 16 * j) * AL + ty * 4 + i];
        const float d = norm_pre(xh, gam[i], bet[i]) > 0.0f ? dh[i][j] : 0.0f;
        dgs[i] += d * xh;
        dbs[i] += d;
      }

    if (blockIdx.y == 0 && tid < AT) {
      float s = 0.0f;
      for (int n = 0; n < AT; ++n) s += ds[n * AL + tid];
      kahan_add(dcb, dcb_c, s);
    }
  }

  const long long dw_base = (long long)chunk * C * Co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx + 16 * j;
      if (c < C && o < Co) part_dw[dw_base + (long long)c * Co + o] = dw[i][j];
    }
  }
  // the 16 threads of a half-warp share their channels: sum them in a fixed order
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      dgs[i] += __shfl_xor_sync(0xffffffffu, dgs[i], off);
      dbs[i] += __shfl_xor_sync(0xffffffffu, dbs[i], off);
    }
  if (tx == 0) {
    const long long base = ((long long)chunk * gridDim.z + blockIdx.z) * C;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + ty * 4 + i;
      if (c < C) {
        part_dg[base + c] = dgs[i];
        part_db[base + c] = dbs[i];
      }
    }
  }
  if (blockIdx.y == 0 && tid < AT && o0 + tid < Co) part_dcb[(long long)chunk * Co + o0 + tid] = dcb;
}

// Each of dW (C * Co), dcb (Co), dgamma (C), dbeta (C) summed over its
// partials in order (Kahan): one thread per output, from output `first` on
// (C * Co + Co: dgamma and dbeta only).
__global__ void __launch_bounds__(kThreads)
pointwise_bwd_finalize_kernel(const float* __restrict__ part_dw, const float* __restrict__ part_dcb,
                              const float* __restrict__ part_dg, const float* __restrict__ part_db,
                              float* __restrict__ dW, float* __restrict__ dcb,
                              float* __restrict__ dg, float* __restrict__ db, int C, int Co,
                              int chunks, int o_tiles, long long first) {
  const long long i = first + (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n_dw = (long long)C * Co;
  const float* src;
  float* dst;
  long long stride;
  int terms;
  if (i < n_dw) {
    src = part_dw + i, dst = dW + i, stride = n_dw, terms = chunks;
  } else if (i < n_dw + Co) {
    const long long j = i - n_dw;
    src = part_dcb + j, dst = dcb + j, stride = Co, terms = chunks;
  } else if (i < n_dw + Co + C) {
    const long long j = i - n_dw - Co;
    src = part_dg + j, dst = dg + j, stride = C, terms = chunks * o_tiles;
  } else if (i < n_dw + Co + 2 * C) {
    const long long j = i - n_dw - Co - C;
    src = part_db + j, dst = db + j, stride = C, terms = chunks * o_tiles;
  } else {
    return;
  }
  float sum = 0.0f, comp = 0.0f;
  for (int t = 0; t < terms; ++t) kahan_add(sum, comp, src[t * stride]);
  *dst = sum;
}

// ---------------------------------------------------------------------------
// bfloat16 on tensor cores: pointwise_fwd_tc and pointwise_bwd_reduce_tc
// ---------------------------------------------------------------------------
//
// Both stream x (and dy) through shared memory in units of 64 rows x 64
// channels, three units in flight (cp.async, 16 bytes a copy), normalise,
// rectify and round x to bf16 on the way into the operand tile, and run the
// products with mma.sync.m16n8k16 (bf16 in, float32 sums) from ldmatrix.
// A unit's rows n0 .. n0 + 63 lie in memory in one of three ways (MODE):
//
//  * kModeS, S % 64 == 0: the rows share one b; each channel's 64 rows are
//    one run along s. A unit is 64 runs, one per channel.
//  * kModeB, 64 % S == 0 (S = 1 .. 32): the rows are 64 / S whole b; the
//    channels c0 .. c0 + 63 of one b are one run of 64 S elements, so the
//    contiguous axis is c. A unit is 64 / S runs, copied in the run's own
//    order ("flat": (j, c, p) at j 64 S + c S + p) and permuted into the
//    operand tile by the conversion pass.
//  * kModeG, any other S (25, 33, 7 in the tests) or a row stride that is
//    not a multiple of 16 bytes: element by element through registers,
//    into the same tiles as kModeS. TMA would need 16-byte row strides too,
//    which these shapes do not give, and kModeS / kModeB get what TMA would
//    (whole 16-byte pieces, no registers) from cp.async.
//
// Operand tiles are bf16 rows of 64 padded to 72 (TC_LD), so the eight rows
// of an ldmatrix fall in distinct banks. Sums are float32: products of two
// bf16 values are exact in float32, so only the order of the sums differs
// from the plain version.

#define TC_THREADS 128  // 4 warps
#define TC_T 64         // rows, channels and outputs of a unit or tile
#define TC_LD 72        // bf16 row stride of operand tiles
#define TC_STAGES 3
#define TC_ONES 0x3F803F80u  // two bf16 1.0
#define TC_MAX_C 1024   // pointwise_fwd_tc stages all of W's C rows (C x 64 outputs)

enum { kModeG = 0, kModeS = 1, kModeB = 2 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a @ b, bf16 operands, float32 accumulators. Fragments for lane l,
// q = l / 4, s = l % 4: d holds rows q (regs 0, 1) and q + 8 (2, 3), columns
// 2s, 2s + 1; a rows q, q + 8 at k = 2s, 2s + 1 (regs 0, 1), 8 + 2s, 9 + 2s
// (2, 3); b column q at k = 2s, 2s + 1 (reg 0), 8 + 2s, 9 + 2s (reg 1).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  const bf16 b = __float2bfloat16(v);
  return *reinterpret_cast<const unsigned short*>(&b);
}

// Where a unit's geometry puts things; lgP = log2 of the run length P
// (kModeB: S; kModeS, kModeG: 64, runs of one channel).
struct Unit {
  int B, R, K, S, lgP;
};

// (channel c, row r) of a unit in its staging buffer: row-major c x ld for
// kModeS and kModeG, flat (j, c, p) for kModeB
template <int MODE>
__device__ __forceinline__ int staged_at(int c, int r, int lgP, int ld) {
  if (MODE == kModeB) return ((r >> lgP) << (6 + lgP)) + (c << lgP) + (r & ((1 << lgP) - 1));
  return c * ld + r;
}

// (c, r) of the element at flat offset e of a kModeB unit
__device__ __forceinline__ void flat_cr(int e, int lgP, int& c, int& r) {
  const int j = e >> (6 + lgP);
  c = (e >> lgP) & (TC_T - 1);
  r = (j << lgP) + (e & ((1 << lgP) - 1));
}

// Channels k0 .. k0 + 63, rows n0 .. n0 + NR - 1 of g [B, K, S] into dst
// (ld: its row stride for kModeS / kModeG), zero outside the tensor. kModeS
// and kModeB: 16-byte cp.async pieces (the caller commits the group);
// kModeG: loads through registers. A unit of NR rows lies in memory as one
// of 64 rows does (kModeS: S % NR == 0; kModeB: NR % S == 0).
template <typename T, int MODE, int NR = TC_T>
__device__ __forceinline__ void stage_unit(T* dst, int ld, const T* __restrict__ g, const Unit& u,
                                           int n0, int k0) {
  constexpr int VE = 16 / sizeof(T);  // elements a piece
  if (MODE == kModeS) {
    const int b = n0 / u.S, s0 = n0 - b * u.S;
    constexpr int PPC = NR / VE;  // pieces a channel
#pragma unroll
    for (int i = 0; i < TC_T * PPC / TC_THREADS; ++i) {
      const int pi = threadIdx.x + i * TC_THREADS, c = pi / PPC, e = (pi % PPC) * VE;
      const bool ok = k0 + c < u.K;
      const T* src = ok ? g + ((long long)b * u.K + k0 + c) * u.S + s0 + e : g;
      cp_async16(dst + c * ld + e, src, ok);
    }
  } else if (MODE == kModeB) {
    const int b0 = n0 >> u.lgP, run = TC_T << u.lgP;  // elements of one b's run
#pragma unroll
    for (int i = 0; i < TC_T * NR / VE / TC_THREADS; ++i) {
      const int f = (threadIdx.x + i * TC_THREADS) * VE;
      const int j = f >> (6 + u.lgP), rem = f - j * run, b = b0 + j;
      const bool ok = b < u.B && k0 + (rem >> u.lgP) < u.K;
      const T* src = ok ? g + ((long long)b * u.K + k0) * u.S + rem : g;
      cp_async16(dst + f, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < TC_T * NR; e += TC_THREADS) {
      const int c = e / NR, r = e % NR, n = n0 + r;
      T v = from_f<T>(0.0f);
      if (n < u.R && k0 + c < u.K) {
        const int b = n / u.S;
        v = g[((long long)b * u.K + k0 + c) * u.S + (n - b * u.S)];
      }
      dst[c * ld + r] = v;
    }
  }
}

// W[k0 + c, o0 : o0 + width] for c < rows → ws[c][o] (row stride ld; width
// a multiple of 8), zero outside W: 16-byte cp.async pieces (joining the
// caller's next commit group) where wvec (Co a multiple of 8, W 16-byte
// aligned: a piece is in W whole or not at all), else element by element.
__device__ __forceinline__ void stage_w(bf16* ws, int ld, const bf16* __restrict__ W, int rows,
                                        int k0, int C, int Co, int o0, int width, bool wvec) {
  if (wvec) {
    const int per_row = width / 8;
    for (int pi = threadIdx.x; pi < rows * per_row; pi += TC_THREADS) {
      const int c = pi / per_row, o = (pi % per_row) * 8;
      const bool ok = k0 + c < C && o0 + o < Co;
      cp_async16(ws + c * ld + o, ok ? W + (long long)(k0 + c) * Co + o0 + o : W, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * width; e += TC_THREADS) {
      const int c = e / width, o = e % width;
      ws[c * ld + o] = (k0 + c < C && o0 + o < Co) ? W[(long long)(k0 + c) * Co + o0 + o]
                                                   : from_f<bf16>(0.0f);
    }
  }
}

// G consecutive staged elements as float: float32 as one 4G-byte load,
// bf16 as one 2G-byte load widened exactly (a bf16 is the top half of its
// float)
template <int G>
__device__ __forceinline__ void load_run(const float* p, float (&v)[G]) {
  if constexpr (G == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (G == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}
template <int G>
__device__ __forceinline__ void load_run(const bf16* p, float (&v)[G]) {
  if constexpr (G == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(t.x << 16), v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16), v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else if constexpr (G == 2) {
    const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
    v[0] = __uint_as_float(t << 16), v[1] = __uint_as_float(t & 0xffff0000u);
  } else {
    v[0] = __uint_as_float((uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
  }
}

// Per-channel (mean, inv, gamma, beta) of channel c in shared memory
struct ChanNorm {
  float mean, inv, gamma, beta;
};

// The stand-in for xhat where the mask h > 0 is off (or the element is
// outside the tensor): where the mask is on, xhat is never NaN
#define TC_OFF __int_as_float(0x7fffffff)

// The staged x unit (channels c0 .., rows n0 ..) → hs[c][r] = round_bf16(h),
// 0 past C or R, G elements (c, r .. r + G - 1) at a time; where XM, also
// xm[c][r] = xhat where h > 0 and TC_OFF elsewhere (at xm's own index, row
// stride TC_XLD; xm may be xs itself for float32 x). xhat and
// gamma * xhat + beta round each operation on its own, as norm_xhat and
// norm_pre do.
#define TC_XLD 68  // float32 row stride of xm (and of float32 staged x)

template <typename TX, int MODE, bool XM, int G>
__device__ __forceinline__ void convert_runs(bf16* hs, float* xm, const TX* xs, int ldx,
                                             const ChanNorm* norms, const Unit& u, int n0,
                                             int c0) {
  for (int e = G * threadIdx.x; e < TC_T * TC_T; e += G * TC_THREADS) {
    int c, r;
    if (MODE == kModeB) {
      flat_cr(e, u.lgP, c, r);
    } else {
      c = e / TC_T, r = e % TC_T;
    }
    float v[G], h[G], xq[G];
    load_run<G>(xs + (MODE == kModeB ? e : c * ldx + r), v);
    const ChanNorm nc = norms[c];
    const bool ch = c0 + c < u.K;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const bool ok = ch && n0 + r + k < u.R;
      const float xh = __fmul_rn(__fsub_rn(v[k], nc.mean), nc.inv);
      const float pre = __fadd_rn(__fmul_rn(nc.gamma, xh), nc.beta);
      h[k] = ok ? round_to<bf16>(relu(pre)) : 0.0f;
      xq[k] = ok && pre > 0.0f ? xh : TC_OFF;
    }
    bf16* hp = hs + c * TC_LD + r;
    if constexpr (G == 4) {
      *reinterpret_cast<uint2*>(hp) = make_uint2(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
    } else if constexpr (G == 2) {
      *reinterpret_cast<uint32_t*>(hp) = pack_bf16(h[0], h[1]);
    } else {
      *reinterpret_cast<unsigned short*>(hp) = bf16_bits(h[0]);
    }
    if constexpr (XM) {
      float* xp = xm + (MODE == kModeB ? e : c * TC_XLD + r);
      if constexpr (G == 4) {
        *reinterpret_cast<float4*>(xp) = make_float4(xq[0], xq[1], xq[2], xq[3]);
      } else if constexpr (G == 2) {
        *reinterpret_cast<float2*>(xp) = make_float2(xq[0], xq[1]);
      } else {
        *xp = xq[0];
      }
    }
  }
}

// convert_runs by the unit's run length: four rows at a time where runs
// are at least 4 long, else 2 (S = 2) or 1 (S = 1, where neighbours in the
// staging buffer are channels)
template <typename TX, int MODE, bool XM>
__device__ __forceinline__ void convert_h(bf16* hs, float* xm, const TX* xs, int ldx,
                                          const ChanNorm* norms, const Unit& u, int n0, int c0) {
  if (MODE != kModeB || u.lgP >= 2) {
    convert_runs<TX, MODE, XM, 4>(hs, xm, xs, ldx, norms, u, n0, c0);
  } else if (u.lgP == 1) {
    convert_runs<TX, MODE, XM, 2>(hs, xm, xs, ldx, norms, u, n0, c0);
  } else {
    convert_runs<TX, MODE, XM, 1>(hs, xm, xs, ldx, norms, u, n0, c0);
  }
}

// A kModeB dy unit of NR rows, flat → ds[o][r] (already zero past Co and B)
template <int NR = TC_T>
__device__ __forceinline__ void permute_flat(bf16* ds, const bf16* flat, int lgP) {
  const unsigned short* src = reinterpret_cast<const unsigned short*>(flat);
  unsigned short* dst = reinterpret_cast<unsigned short*>(ds);
  for (int e = threadIdx.x; e < TC_T * NR; e += TC_THREADS) {
    int c, r;
    flat_cr(e, lgP, c, r);
    dst[c * TC_LD + r] = src[e];
  }
}

// ---------------------------------------------------------------------------
// pointwise_fwd_tc: y = W^T round(h) + cb
// ---------------------------------------------------------------------------
//
// A block owns 64 outputs (blockIdx.y) and every gridDim.x-th row tile from
// blockIdx.x: W[:, o0 : o0 + 64] is staged once for all of them. Its units
// are (row tile, 64-channel chunk); each warp computes 16 outputs x 64 rows,
// A = W^T from the W tile through ldmatrix.trans, B = round(h) from hs
// through ldmatrix.trans. After a tile's last chunk the accumulators plus cb
// go to a bf16 tile laid out as y lies in memory, and out as 16-byte stores.

template <typename TX>
struct FwdSmem {
  static size_t bytes(int C) {
    const int CP = (C + TC_T - 1) / TC_T * TC_T;
    return sizeof(TX) * TC_STAGES * TC_T * ldx() + sizeof(bf16) * (2 * TC_T * TC_LD + CP * TC_LD) +
           sizeof(ChanNorm) * CP + sizeof(float) * TC_T;
  }
  // staged x row stride: rows of 64 padded by 16 bytes, so that reads of a
  // column by the lanes of a quad fall in distinct banks
  static constexpr __host__ __device__ int ldx() { return TC_T + 16 / (int)sizeof(TX); }
};

template <typename TX, int MODE>
__global__ void __launch_bounds__(TC_THREADS, 2)
pointwise_fwd_tc(const TX* __restrict__ x, Norm p, const bf16* __restrict__ W,
                 const float* __restrict__ cb, bf16* __restrict__ y, int B, int C, int Co, int S,
                 int lgP, bool wvec) {
  constexpr int LDX = FwdSmem<TX>::ldx();
  const int CP = (C + TC_T - 1) / TC_T * TC_T, chunks = CP / TC_T;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  TX* xs = reinterpret_cast<TX*>(tc_smem);  // [STAGES][64][LDX]
  bf16* hs = reinterpret_cast<bf16*>(xs + TC_STAGES * TC_T * LDX);  // [64][TC_LD]
  bf16* ys = hs + TC_T * TC_LD;  // [64][TC_LD] or flat
  bf16* ws = ys + TC_T * TC_LD;  // [CP][TC_LD]
  ChanNorm* norms = reinterpret_cast<ChanNorm*>(ws + CP * TC_LD);  // [CP]
  float* cbs = reinterpret_cast<float*>(norms + CP);  // [64]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, q = lane / 4, s = lane % 4;
  const int o0 = blockIdx.y * TC_T;
  const Unit ux{B, B * S, C, S, lgP};
  const int tiles = (ux.R + TC_T - 1) / TC_T;
  const int my_tiles = tiles > (int)blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int units = my_tiles * chunks;

  auto fetch = [&](int i) {
    if (i < units) {
      const int n0 = (blockIdx.x + (i / chunks) * gridDim.x) * TC_T, k0 = (i % chunks) * TC_T;
      stage_unit<TX, MODE>(xs + (i % TC_STAGES) * TC_T * LDX, LDX, x, ux, n0, k0);
    }
    cp_async_commit();
  };
  // W[:, o0 : o0 + 64] as ws[c][o], zero past C and Co (with unit 0's
  // group); the statistics; cb
  stage_w(ws, TC_LD, W, CP, 0, C, Co, o0, TC_T, wvec);
  for (int i = 0; i < TC_STAGES - 1; ++i) fetch(i);
  for (int c = tid; c < CP; c += TC_THREADS) {
    norms[c] = c < C ? ChanNorm{p.mean[c], p.inv[c], p.gamma[c], p.beta[c]}
                     : ChanNorm{0.0f, 0.0f, 0.0f, 0.0f};
  }
  if (tid < TC_T) cbs[tid] = o0 + tid < Co ? cb[o0 + tid] : 0.0f;

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int i = 0; i < units; ++i) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // unit i is in place; unit i - 1's readers are done
    fetch(i + TC_STAGES - 1);
    const int kc = i % chunks, n0 = (blockIdx.x + (i / chunks) * gridDim.x) * TC_T;
    convert_h<TX, MODE, false>(hs, nullptr, xs + (i % TC_STAGES) * TC_T * LDX, LDX,
                               norms + kc * TC_T, ux, n0, kc * TC_T);
    __syncthreads();

    // acc[n] (outputs 16 warp + q (+8), rows 8n + 2s (+1)) += W^T h
    const bf16* wt = ws + kc * TC_T * TC_LD;
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t a[4];
      ldsm_x4_t(a, wt + (kt * 16 + (lane & 7) + (lane >> 4) * 8) * TC_LD + 16 * warp +
                       ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, hs + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_LD + np * 16 +
                         (lane >> 4) * 8);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    if (kc != chunks - 1) continue;

    // the tile's y in bf16, laid out as in memory (MODE), then out
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int o = 16 * warp + q + 8 * hi, r = 8 * n + 2 * s;
        const float v0 = acc[n][2 * hi] + cbs[o], v1 = acc[n][2 * hi + 1] + cbs[o];
        acc[n][2 * hi] = acc[n][2 * hi + 1] = 0.0f;
        if (MODE == kModeB && lgP == 0) {
          unsigned short* yb = reinterpret_cast<unsigned short*>(ys);
          yb[staged_at<MODE>(o, r, lgP, TC_LD)] = bf16_bits(v0);
          yb[staged_at<MODE>(o, r + 1, lgP, TC_LD)] = bf16_bits(v1);
        } else {
          *reinterpret_cast<uint32_t*>(ys + staged_at<MODE>(o, r, lgP, TC_LD)) = pack_bf16(v0, v1);
        }
      }
    __syncthreads();
    if (MODE == kModeS) {
      const int b = n0 / S, s0 = n0 - b * S;
#pragma unroll
      for (int k = 0; k < TC_T * 8 / TC_THREADS; ++k) {
        const int pi = tid + k * TC_THREADS, o = pi / 8, e = (pi % 8) * 8;
        if (o0 + o < Co) {
          *reinterpret_cast<uint4*>(y + ((long long)b * Co + o0 + o) * S + s0 + e) =
              *reinterpret_cast<const uint4*>(ys + o * TC_LD + e);
        }
      }
    } else if (MODE == kModeB) {
      const int b0 = n0 >> lgP, run = TC_T << lgP;
#pragma unroll
      for (int k = 0; k < TC_T * TC_T / 8 / TC_THREADS; ++k) {
        const int f = (tid + k * TC_THREADS) * 8, j = f >> (6 + lgP), rem = f - j * run;
        if (b0 + j < B && o0 + (rem >> lgP) < Co) {
          *reinterpret_cast<uint4*>(y + ((long long)(b0 + j) * Co + o0) * S + rem) =
              *reinterpret_cast<const uint4*>(ys + f);
        }
      }
    } else {
      for (int e = tid; e < TC_T * TC_T; e += TC_THREADS) {
        const int o = e / TC_T, r = e % TC_T, n = n0 + r;
        if (n < ux.R && o0 + o < Co) {
          const int b = n / S;
          y[((long long)b * Co + o0 + o) * S + (n - b * S)] = ys[o * TC_LD + r];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// pointwise_bwd_reduce_tc: pass A's partial sums per row chunk
// ---------------------------------------------------------------------------
//
// A block owns (row chunk, 64 channels, 64 outputs), as the CUDA-core pass A
// does, and streams its chunk's units of x and dy (three in flight). Each
// warp owns 16 channels: dW's partial over the unit (A = round(h) from hs,
// B = dy^T from ds, both through ldmatrix) joins the running dW by Kahan
// addition; dh over this output tile (A = W from the W tile, B = dy through
// ldmatrix.trans) is summed, where the conversion left xhat in xm (the mask
// h > 0 is on), into dgamma and dbeta (Kahan across units); blocks of the
// first channel tile also sum dcb = ones @ dy^T on the tensor cores, each
// warp for 16 outputs. With one chunk the block writes dW and dcb as they
// are (no scratch); dgamma and dbeta are partials over the output tiles.
//
// Why 64 x 64 tiles, so that x is converted once per output tile and dy
// loaded once per channel tile (the rereads mostly from L2: the grid is
// one wave, and the blocks of a chunk run together): a block's share of dW
// is held with its Kahan compensation in registers, 2 x 32 floats a
// thread for 64 x 64, and W at 320 x 320 (200 KB in bf16) would not fit in
// shared memory beside the staging buffers. The chunks (the wrapper's
// reduce_tc_chunks) fill one wave of the card while keeping the partials'
// traffic below the bytes of x, dy and W.

template <typename TX>
struct ReduceSmem {
  // float32 x is turned into xm in place; bf16 x needs its own xm tile
  static constexpr bool kOwnXm = sizeof(TX) != sizeof(float);
  static constexpr size_t bytes() {
    return sizeof(TX) * TC_STAGES * TC_T * FwdSmem<TX>::ldx() +
           sizeof(bf16) * (TC_STAGES * TC_T * TC_LD + 3 * TC_T * TC_LD) + sizeof(ChanNorm) * TC_T +
           (kOwnXm ? sizeof(float) * TC_T * TC_XLD : 0);
  }
};

template <typename TX, int MODE>
__global__ void __launch_bounds__(TC_THREADS, 2)
pointwise_bwd_reduce_tc(const TX* __restrict__ x, Norm p, const bf16* __restrict__ W,
                        const bf16* __restrict__ dy, float* __restrict__ part_dw,
                        float* __restrict__ part_dcb, float* __restrict__ part_dg,
                        float* __restrict__ part_db, int B, int C, int Co, int S, int lgP,
                        int chunk_rows, bool wvec) {
  constexpr int LDX = FwdSmem<TX>::ldx();
  extern __shared__ __align__(16) unsigned char tc_smem[];
  TX* xs = reinterpret_cast<TX*>(tc_smem);  // [STAGES][64][LDX]
  bf16* dys = reinterpret_cast<bf16*>(xs + TC_STAGES * TC_T * LDX);  // [STAGES][64][TC_LD]
  bf16* hs = dys + TC_STAGES * TC_T * TC_LD;  // [64][TC_LD]
  bf16* dsb = hs + TC_T * TC_LD;  // kModeB's permuted dy
  bf16* ws = dsb + TC_T * TC_LD;  // [64][TC_LD]: W[c0 + c, o0 + o]
  ChanNorm* norms = reinterpret_cast<ChanNorm*>(ws + TC_T * TC_LD);  // [64]
  float* own_xm = reinterpret_cast<float*>(norms + TC_T);  // [64][TC_XLD] (bf16 x)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, q = lane / 4, s = lane % 4;
  const int chunk = blockIdx.x, c0 = blockIdx.y * TC_T, o0 = blockIdx.z * TC_T;
  const bool first_ctile = blockIdx.y == 0;
  const int R = B * S;
  const int n_begin = chunk * chunk_rows, n_end = min(R, n_begin + chunk_rows);
  const int units = (n_end - n_begin + TC_T - 1) / TC_T;
  const Unit ux{B, R, C, S, lgP}, uy{B, R, Co, S, lgP};

  auto fetch = [&](int i) {
    if (i < units) {
      const int n0 = n_begin + i * TC_T, st = i % TC_STAGES;
      stage_unit<TX, MODE>(xs + st * TC_T * LDX, LDX, x, ux, n0, c0);
      stage_unit<bf16, MODE>(dys + st * TC_T * TC_LD, TC_LD, dy, uy, n0, o0);
    }
    cp_async_commit();
  };
  stage_w(ws, TC_LD, W, TC_T, c0, C, Co, o0, TC_T, wvec);  // with unit 0's group
  for (int i = 0; i < TC_STAGES - 1; ++i) fetch(i);
  if (tid < TC_T) {
    const int c = c0 + tid;
    norms[tid] = c < C ? ChanNorm{p.mean[c], p.inv[c], p.gamma[c], p.beta[c]}
                       : ChanNorm{0.0f, 0.0f, 0.0f, 0.0f};
  }

  // running sums with their compensations: dW of channels 16 warp + q (+8),
  // outputs 8n + 2s (+1); dgamma, dbeta of channels 16 warp + q (+8) over
  // the lane's rows; dcb of outputs 16 warp + 8j + 2s (+1) (row q = 0 of
  // the ones product)
  float dw[8][4], dwc[8][4], dg[2], dgc[2], db[2], dbc[2], dcb[2][2], dcbc[2][2];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) dw[n][k] = dwc[n][k] = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dg[i] = dgc[i] = db[i] = dbc[i] = 0.0f;
    dcb[i][0] = dcb[i][1] = dcbc[i][0] = dcbc[i][1] = 0.0f;
  }
  const uint32_t ones[4] = {TC_ONES, TC_ONES, TC_ONES, TC_ONES};

  for (int i = 0; i < units; ++i) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // unit i is in place; unit i - 1's readers are done
    fetch(i + TC_STAGES - 1);
    const int n0 = n_begin + i * TC_T, st = i % TC_STAGES;
    TX* xu = xs + st * TC_T * LDX;
    const bf16* ds = dys + st * TC_T * TC_LD;
    float* xm = ReduceSmem<TX>::kOwnXm ? own_xm : reinterpret_cast<float*>(xu);
    convert_h<TX, MODE, true>(hs, xm, xu, LDX, norms, ux, n0, c0);
    if (MODE == kModeB) {
      permute_flat(dsb, ds, lgP);
      ds = dsb;
    }
    __syncthreads();

    // dW (channels x outputs) over the unit's rows: A = round(h) [c][r], B
    // (k = row, n = output) from ds [o][r] without .trans; dcb = ones @ dy^T
    {
      float part[8][4], pb[2][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) pb[j][0] = pb[j][1] = pb[j][2] = pb[j][3] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        uint32_t a[4];
        ldsm_x4(a, hs + (16 * warp + (lane & 15)) * TC_LD + kt * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4(b, ds + (np * 16 + (lane & 7) + (lane >> 4) * 8) * TC_LD + kt * 16 +
                         ((lane >> 3) & 1) * 8);
          mma_bf16(part[2 * np], a, b[0], b[1]);
          mma_bf16(part[2 * np + 1], a, b[2], b[3]);
          if (first_ctile && np == warp) {
            mma_bf16(pb[0], ones, b[0], b[1]);
            mma_bf16(pb[1], ones, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) kahan_add(dw[n][k], dwc[n][k], part[n][k]);
      if (first_ctile) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) kahan_add(dcb[j][e], dcbc[j][e], pb[j][e]);
      }
    }

    // dh (channels x rows) over this output tile: A = W [c][o], B (k =
    // output, n = row) from ds [o][r] through .trans; then, where xm holds
    // xhat (the mask is on), the unit's dgamma and dbeta
    {
      float dh[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) dh[n][0] = dh[n][1] = dh[n][2] = dh[n][3] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        uint32_t a[4];
        ldsm_x4(a, ws + (16 * warp + (lane & 15)) * TC_LD + kt * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4_t(b, ds + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_LD + np * 16 +
                           (lane >> 4) * 8);
          mma_bf16(dh[2 * np], a, b[0], b[1]);
          mma_bf16(dh[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int c = 16 * warp + q + 8 * hi;
        float tg = 0.0f, tb = 0.0f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float xh = xm[staged_at<MODE>(c, 8 * n + 2 * s + e, lgP, TC_XLD)];
            if (xh == xh) {  // not TC_OFF
              tg += dh[n][2 * hi + e] * xh;
              tb += dh[n][2 * hi + e];
            }
          }
        kahan_add(dg[hi], dgc[hi], tg);
        kahan_add(db[hi], dbc[hi], tb);
      }
    }
  }
  cp_async_wait<0>();

  // dW (or its chunk's partial); the compensated totals are sum - comp
  const long long dw_base = (long long)chunk * C * Co;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + 16 * warp + q + 8 * (k >> 1), o = o0 + 8 * n + 2 * s + (k & 1);
      if (c < C && o < Co) part_dw[dw_base + (long long)c * Co + o] = dw[n][k] - dwc[n][k];
    }
  // dgamma, dbeta: the four lanes of a quad share their channels
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    float g = dg[hi] - dgc[hi], bb = db[hi] - dbc[hi];
    g += __shfl_xor_sync(0xffffffffu, g, 1);
    bb += __shfl_xor_sync(0xffffffffu, bb, 1);
    g += __shfl_xor_sync(0xffffffffu, g, 2);
    bb += __shfl_xor_sync(0xffffffffu, bb, 2);
    const int c = c0 + 16 * warp + q + 8 * hi;
    if (s == 0 && c < C) {
      const long long at = ((long long)chunk * gridDim.z + blockIdx.z) * C + c;
      part_dg[at] = g;
      part_db[at] = bb;
    }
  }
  if (first_ctile && q == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = o0 + 16 * warp + 8 * j + 2 * s + e;
        if (o < Co) part_dcb[(long long)chunk * Co + o] = dcb[j][e] - dcbc[j][e];
      }
  }
}

// ---------------------------------------------------------------------------
// pointwise_bwd_dx_tc: pass B, dx = gamma * inv * (dh - dbeta / R - xhat * dgamma / R)
// ---------------------------------------------------------------------------
//
// dh[c, n] = sum_o W[c, o] dy[o, n]: the forward's product with W's other
// axis. A block owns 64 channels (blockIdx.y) and every gridDim.x-th row
// tile of NR rows from blockIdx.x; NR is 64, 32 or 16 (the wrapper's
// dx_tc_rows, a function of the shape: smaller where 64-row tiles would
// leave the card without a wave of blocks). The block stages W[c0 : c0 + 64,
// :] once, as the A operand (ldmatrix from rows of Co), and streams dy in
// units of 64 outputs x NR rows, three in flight, each warp summing dh of
// its 16 channels x NR rows over the whole of Co in its accumulators (B =
// dy through ldmatrix.trans): no split over Co, no atomics. The row tile's
// x unit arrives with its last output chunk; the epilogue reads x from it,
// recomputes xhat and the mask h > 0 (__fmul_rn / __fadd_rn, as the other
// kernels), writes dx over x in place, and the tile goes out as 16-byte
// stores in x's layout and dtype. The x tiles in flight (xslots): a row
// tile's x lives from its last chunk's fetch to its epilogue, two units
// later, so 3 slots with one output chunk, 2 with two, 1 with more.

// The staged tile src (channels k0 .., rows n0 .. n0 + NR - 1, laid out as
// stage_unit puts it) out to g [B, K, S], inside the tensor only: 16-byte
// pieces for kModeS and kModeB, element by element for kModeG
template <typename T, int MODE, int NR>
__device__ __forceinline__ void store_unit(T* __restrict__ g, const T* src, int ld, const Unit& u,
                                           int n0, int k0) {
  constexpr int VE = 16 / sizeof(T);
  if (MODE == kModeS) {
    const int b = n0 / u.S, s0 = n0 - b * u.S;
    constexpr int PPC = NR / VE;
#pragma unroll
    for (int i = 0; i < TC_T * PPC / TC_THREADS; ++i) {
      const int pi = threadIdx.x + i * TC_THREADS, c = pi / PPC, e = (pi % PPC) * VE;
      if (k0 + c < u.K) {
        *reinterpret_cast<uint4*>(g + ((long long)b * u.K + k0 + c) * u.S + s0 + e) =
            *reinterpret_cast<const uint4*>(src + c * ld + e);
      }
    }
  } else if (MODE == kModeB) {
    const int b0 = n0 >> u.lgP, run = TC_T << u.lgP;
#pragma unroll
    for (int i = 0; i < TC_T * NR / VE / TC_THREADS; ++i) {
      const int f = (threadIdx.x + i * TC_THREADS) * VE;
      const int j = f >> (6 + u.lgP), rem = f - j * run, b = b0 + j;
      if (b < u.B && k0 + (rem >> u.lgP) < u.K) {
        *reinterpret_cast<uint4*>(g + ((long long)b * u.K + k0) * u.S + rem) =
            *reinterpret_cast<const uint4*>(src + f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < TC_T * NR; e += TC_THREADS) {
      const int c = e / NR, r = e % NR, n = n0 + r;
      if (n < u.R && k0 + c < u.K) {
        const int b = n / u.S;
        g[((long long)b * u.K + k0 + c) * u.S + (n - b * u.S)] = src[c * ld + r];
      }
    }
  }
}

template <typename TX>
struct DxSmem {
  // W's slice [64][CoP + 8]: rows of 2 (CoP + 8) bytes, so that the eight
  // rows of an ldmatrix fall in distinct banks
  static __host__ __device__ int wld(int Co) { return (Co + TC_T - 1) / TC_T * TC_T + 8; }
  static __host__ __device__ int xslots(int Co) {
    const int chunks = (Co + TC_T - 1) / TC_T;
    return chunks >= TC_STAGES ? 1 : TC_STAGES + 1 - chunks;
  }
  static size_t bytes(int Co) {
    return sizeof(TX) * xslots(Co) * TC_T * FwdSmem<TX>::ldx() +
           sizeof(bf16) * ((TC_STAGES + 1) * TC_T * TC_LD + TC_T * wld(Co));
  }
};

template <typename TX, int MODE, int NR>
__global__ void __launch_bounds__(TC_THREADS, 2)
pointwise_bwd_dx_tc(const TX* __restrict__ x, Norm p, const bf16* __restrict__ W,
                    const bf16* __restrict__ dy, const float* __restrict__ dg,
                    const float* __restrict__ db, TX* __restrict__ dx, int B, int C, int Co,
                    int S, int lgP, bool wvec) {
  constexpr int LDX = FwdSmem<TX>::ldx(), NT = NR / 8;  // NT: 8-row mma tiles a unit
  const int chunks = (Co + TC_T - 1) / TC_T, WLD = DxSmem<TX>::wld(Co);
  const int xslots = DxSmem<TX>::xslots(Co);
  extern __shared__ __align__(16) unsigned char tc_smem[];
  TX* xs = reinterpret_cast<TX*>(tc_smem);  // [xslots][64][LDX] or flat
  bf16* dys = reinterpret_cast<bf16*>(xs + xslots * TC_T * LDX);  // [STAGES][64][TC_LD] or flat
  bf16* dsb = dys + TC_STAGES * TC_T * TC_LD;  // kModeB's permuted dy
  bf16* ws = dsb + TC_T * TC_LD;  // [64][WLD]: W[c0 + c, o]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, q = lane / 4, s = lane % 4;
  const int c0 = blockIdx.y * TC_T, R = B * S;
  const Unit ux{B, R, C, S, lgP}, uy{B, R, Co, S, lgP};
  const int tiles = (R + NR - 1) / NR;
  const int my_tiles = tiles > (int)blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int units = my_tiles * chunks;

  auto fetch = [&](int i) {
    if (i < units) {
      const int t = i / chunks, kc = i % chunks, n0 = (blockIdx.x + t * gridDim.x) * NR;
      stage_unit<bf16, MODE, NR>(dys + (i % TC_STAGES) * TC_T * TC_LD, TC_LD, dy, uy, n0,
                                 kc * TC_T);
      if (kc == chunks - 1)
        stage_unit<TX, MODE, NR>(xs + (t % xslots) * TC_T * LDX, LDX, x, ux, n0, c0);
    }
    cp_async_commit();
  };
  stage_w(ws, WLD, W, TC_T, c0, C, Co, 0, WLD - 8, wvec);  // with unit 0's group
  for (int i = 0; i < TC_STAGES - 1; ++i) fetch(i);

  // the lane's channels 16 warp + q (+8): statistics, gamma * inv, dbeta / R
  // and dgamma (zero past C)
  const float rows = (float)R;
  float mean[2], inv[2], gam[2], bet[2], ginv[2], dbr[2], dgc[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int c = c0 + 16 * warp + q + 8 * hi;
    const bool ok = c < C;
    mean[hi] = ok ? __ldg(p.mean + c) : 0.0f;
    inv[hi] = ok ? __ldg(p.inv + c) : 0.0f;
    gam[hi] = ok ? __ldg(p.gamma + c) : 0.0f;
    bet[hi] = ok ? __ldg(p.beta + c) : 0.0f;
    ginv[hi] = __fmul_rn(gam[hi], inv[hi]);
    dbr[hi] = __fdiv_rn(ok ? __ldg(db + c) : 0.0f, rows);
    dgc[hi] = ok ? __ldg(dg + c) : 0.0f;
  }

  // dh of channels 16 warp + q (+8), rows 8n + 2s (+1)
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int i = 0; i < units; ++i) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // unit i is in place; unit i - 1's readers are done
    fetch(i + TC_STAGES - 1);
    const int t = i / chunks, kc = i % chunks;
    const bf16* ds = dys + (i % TC_STAGES) * TC_T * TC_LD;
    if (MODE == kModeB) {
      permute_flat<NR>(dsb, ds, lgP);
      ds = dsb;
      __syncthreads();
    }

    // acc += W[:, chunk kc] dy: A = W [c][o], B (k = output, n = row) from
    // ds [o][r] through .trans
    const bf16* wk = ws + kc * TC_T;
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t a[4];
      ldsm_x4(a, wk + (16 * warp + (lane & 15)) * WLD + kt * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, ds + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_LD + np * 16 +
                         (lane >> 4) * 8);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    if (kc != chunks - 1) continue;

    // the tile's dx over its x, in place, then out
    TX* xu = xs + (t % xslots) * TC_T * LDX;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int hi = k >> 1, at = staged_at<MODE>(16 * warp + q + 8 * hi, 8 * n + 2 * s + (k & 1),
                                                    lgP, LDX);
        const float xh = __fmul_rn(__fsub_rn(to_f<TX>(xu[at]), mean[hi]), inv[hi]);
        const float d = norm_pre(xh, gam[hi], bet[hi]) > 0.0f ? acc[n][k] : 0.0f;
        const float v = __fmul_rn(
            ginv[hi], __fsub_rn(__fsub_rn(d, dbr[hi]), __fdiv_rn(__fmul_rn(xh, dgc[hi]), rows)));
        xu[at] = from_f<TX>(v);
        acc[n][k] = 0.0f;
      }
    __syncthreads();
    store_unit<TX, MODE, NR>(dx, xu, LDX, ux, (blockIdx.x + t * gridDim.x) * NR, c0);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// pointwise_stats: the fused op's batch statistics and bn1's running update
// ---------------------------------------------------------------------------
//
// For each channel of x [B, C, S] (float32 or bf16), over its n = B * S
// elements: mean, the biased variance var, inv = 1 / sqrt(var + eps) (each
// operation correctly rounded, as ops/pointwise.inv_std; never rsqrt) and,
// where asked, nn.BatchNorm's running update. The JAX package takes these
// statistics with XLA outside its Pallas kernel
// (mopoe_mimic_tpu/ops/pallas_pointwise.py:285-288); the port's plain path
// is batch_stats, inv_std and update_running_stats (ops/pointwise.py), some
// 14 device ops and several passes over x. Bound by bytes: x is read once,
// in its own dtype.
//
// pointwise_stats_kernel: one block per (chunk of whole b, group of
// channels); TPC lanes (a power of two up to 32, by S) share a channel and
// read, in each b of the chunk, its run of S elements in groups of G (16
// bytes where S % G == 0). Each lane keeps a Welford state over batches
// (one b's elements a batch): with the running mean as the pivot of the
// batch's sums s1 = sum (x - mean), s2 = sum (x - mean)^2, the batch joins
// as mean += s1 / n', M2 += s2 - s1^2 / n' (Chan's formula for a batch);
// the first element seen is the first pivot. The TPC lanes are merged by
// Chan's formula in a fixed order (xor shuffles) into the chunk's (mean,
// M2) per channel. pointwise_stats_finalize_kernel: one warp per channel
// merges the chunks in a fixed order (lane l takes chunks l, l + 32, ...,
// then xor shuffles), then writes mean, var = M2 / n and inv, and updates
// the running buffers. No atomics: two runs are bitwise equal.

#define ST_THREADS 256

template <typename TX, int G>
__global__ void __launch_bounds__(ST_THREADS)
pointwise_stats_kernel(const TX* __restrict__ x, float* __restrict__ part_mean,
                       float* __restrict__ part_m2, int B, int C, int S, int tpc,
                       int b_per_chunk, bool vec) {
  const int tid = threadIdx.x, sub = tid % tpc;
  const int c = blockIdx.y * (ST_THREADS / tpc) + tid / tpc;
  const int b_begin = blockIdx.x * b_per_chunk, b_end = min(B, b_begin + b_per_chunk);
  const int groups = S / G;  // G elements a group
  int n = 0;
  float mean = 0.0f, m2 = 0.0f;
  if (c < C) {
    for (int b = b_begin; b < b_end; ++b) {
      const TX* run = x + ((long long)b * C + c) * S;
      float s1 = 0.0f, s2 = 0.0f;
      int k = 0;
#pragma unroll 4
      for (int gi = sub; gi < groups; gi += tpc) {
        float v[G];
        if (G > 1 && vec) {
          const uint4 raw = *reinterpret_cast<const uint4*>(run + gi * G);
          const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
          for (int j = 0; j < G; ++j) v[j] = to_f<TX>(e[j]);
        } else {
#pragma unroll
          for (int j = 0; j < G; ++j) v[j] = to_f<TX>(run[gi * G + j]);
        }
        if (n == 0 && k == 0) mean = v[0];  // the first pivot
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float d = v[j] - mean;
          s1 += d;
          s2 = fmaf(d, d, s2);
        }
        k += G;
      }
      if (k > 0) {
        n += k;
        const float r = __frcp_rn((float)n);
        mean = mean + s1 * r;
        m2 = m2 + (s2 - s1 * s1 * r);
      }
    }
  }
  float nf = (float)n;
  chan_merge_lanes(nf, mean, m2, tpc);
  if (c < C && sub == 0) {
    part_mean[(long long)blockIdx.x * C + c] = mean;
    part_m2[(long long)blockIdx.x * C + c] = m2;
  }
}

// One warp per channel: the chunks' (mean, M2), chunk k over
// (min(B, (k + 1) b_per_chunk) - k b_per_chunk) * S elements, merged in a
// fixed order; then the statistics and, where running_mean is given, the
// running update (m: momentum, unbias: n / (n - 1))
__global__ void __launch_bounds__(ST_THREADS)
pointwise_stats_finalize_kernel(const float* __restrict__ part_mean,
                                const float* __restrict__ part_m2, float* __restrict__ mean_out,
                                float* __restrict__ var_out, float* __restrict__ inv_out,
                                float* __restrict__ running_mean, float* __restrict__ running_var,
                                int B, int C, int S, int b_per_chunk, int chunks, float eps,
                                float m, float one_minus_m, float unbias) {
  const int lane = threadIdx.x % 32, c = blockIdx.x * (ST_THREADS / 32) + threadIdx.x / 32;
  if (c >= C) return;  // whole warps
  float n = 0.0f, mean = 0.0f, m2 = 0.0f;
  for (int k = lane; k < chunks; k += 32) {
    const int bs = min(B, (k + 1) * b_per_chunk) - k * b_per_chunk;
    chan_merge(n, mean, m2, (float)bs * (float)S, part_mean[(long long)k * C + c],
               part_m2[(long long)k * C + c]);
  }
  chan_merge_lanes(n, mean, m2, 32);
  if (lane != 0) return;
  const float var = fmaxf(0.0f, __fdiv_rn(m2, n));  // M2 can round below 0
  mean_out[c] = mean;
  var_out[c] = var;
  inv_out[c] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  if (running_mean != nullptr) {  // as mul_(1 - m).add_(stat, alpha=m) rounds on the card
    running_mean[c] = __fmaf_rn(m, mean, __fmul_rn(running_mean[c], one_minus_m));
    running_var[c] = __fmaf_rn(m, __fmul_rn(var, unbias), __fmul_rn(running_var[c], one_minus_m));
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr size_t kReduceSmem = sizeof(float) * 4 * AT * AL;  // 66,560 bytes

bool bad_shape(int B, int C, int Co, int S) {
  return B < 1 || S < 1 || C < 1 || C > kMaxC || Co < 1 || Co > kMaxC;
}

template <typename TX>
int launch_fwd(const void* x, Norm p, const void* W, const float* cb, void* y, int B, int C,
               int Co, int S, cudaStream_t stream) {
  const int R = B * S;
  const dim3 grid((R + FN - 1) / FN, (Co + FP - 1) / FP);
  pointwise_fwd_kernel<TX><<<grid, kThreads, 0, stream>>>(
      (const TX*)x, p, (const float*)W, cb, (float*)y, R, C, Co, S);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_dx(const void* x, Norm p, const void* W, const void* dy, const float* dg,
              const float* db, void* dx, int B, int C, int Co, int S, cudaStream_t stream) {
  const int R = B * S;
  const dim3 grid((R + FN - 1) / FN, (C + FP - 1) / FP);
  pointwise_bwd_dx_kernel<TX><<<grid, kThreads, 0, stream>>>(
      (const TX*)x, p, (const float*)W, (const float*)dy, dg, db, (TX*)dx, R, C, Co, S);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_reduce(const void* x, Norm p, const void* W, const void* dy, float* part_dw,
                  float* part_dcb, float* part_dg, float* part_db, int B, int C, int Co, int S,
                  int chunk_rows, cudaStream_t stream) {
  int wave = 0;
  const cudaError_t err =
      prepare<pointwise_bwd_reduce_kernel<TX>>(kReduceSmem, kThreads, &wave);
  if (err != cudaSuccess) return (int)err;
  const int R = B * S;
  const dim3 grid((R + chunk_rows - 1) / chunk_rows, (C + AT - 1) / AT, (Co + AT - 1) / AT);
  pointwise_bwd_reduce_kernel<TX><<<grid, kThreads, kReduceSmem, stream>>>(
      (const TX*)x, p, (const float*)W, (const float*)dy, part_dw, part_dcb, part_dg, part_db, R,
      C, Co, S, chunk_rows);
  return (int)cudaGetLastError();
}

// The layout mode of a tensor-core launch with units of `rows` rows (see
// kModeS): kModeS where each channel's rows run along s in whole 16-byte
// pieces, kModeB where whole b fill a unit and every (b, 64-channel) run of
// each tensor starts on a 16-byte boundary, else kModeG. lgP: log2 of the
// run length.
int tc_mode(const void* x, size_t x_bytes, const void* other, int C, int Co, int S, int* lgP,
            int rows = TC_T) {
  *lgP = 6;
  if ((uintptr_t)x % 16 != 0 || (uintptr_t)other % 16 != 0) return kModeG;
  if (S % rows == 0) return kModeS;
  if (rows % S != 0 || ((long long)C * S * x_bytes) % 16 != 0 || ((long long)Co * S * 2) % 16 != 0)
    return kModeG;
  *lgP = 0;
  while ((1 << *lgP) < S) ++*lgP;
  return kModeB;
}

// W's 64-output rows go as 16-byte pieces (stage_w)
bool w_vec(const void* W, int Co) { return Co % 8 == 0 && (uintptr_t)W % 16 == 0; }

template <typename TX, int MODE>
int launch_fwd_tc_mode(const void* x, Norm p, const void* W, const float* cb, void* y, int B,
                       int C, int Co, int S, int lgP, cudaStream_t stream) {
  const size_t smem = FwdSmem<TX>::bytes(C);
  int wave = 0;
  const cudaError_t err = prepare<pointwise_fwd_tc<TX, MODE>>(smem, TC_THREADS, &wave);
  if (err != cudaSuccess) return (int)err;
  const int o_tiles = (Co + TC_T - 1) / TC_T, tiles = (B * S + TC_T - 1) / TC_T;
  const int per_o = wave / o_tiles < 1 ? 1 : wave / o_tiles;
  const dim3 grid(tiles < per_o ? tiles : per_o, o_tiles);
  pointwise_fwd_tc<TX, MODE><<<grid, TC_THREADS, smem, stream>>>(
      (const TX*)x, p, (const bf16*)W, cb, (bf16*)y, B, C, Co, S, lgP, w_vec(W, Co));
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_fwd_tc(const void* x, Norm p, const void* W, const float* cb, void* y, int B, int C,
                  int Co, int S, cudaStream_t stream) {
  int lgP = 6;
  switch (tc_mode(x, sizeof(TX), y, C, Co, S, &lgP)) {
    case kModeS:
      return launch_fwd_tc_mode<TX, kModeS>(x, p, W, cb, y, B, C, Co, S, lgP, stream);
    case kModeB:
      return launch_fwd_tc_mode<TX, kModeB>(x, p, W, cb, y, B, C, Co, S, lgP, stream);
    default:
      return launch_fwd_tc_mode<TX, kModeG>(x, p, W, cb, y, B, C, Co, S, lgP, stream);
  }
}

template <typename TX, int MODE>
int launch_reduce_tc_mode(const void* x, Norm p, const void* W, const void* dy, float* part_dw,
                          float* part_dcb, float* part_dg, float* part_db, int B, int C, int Co,
                          int S, int lgP, int chunk_rows, cudaStream_t stream) {
  constexpr size_t smem = ReduceSmem<TX>::bytes();
  int wave = 0;
  const cudaError_t err = prepare<pointwise_bwd_reduce_tc<TX, MODE>>(smem, TC_THREADS, &wave);
  if (err != cudaSuccess) return (int)err;
  const int R = B * S;
  const dim3 grid((R + chunk_rows - 1) / chunk_rows, (C + TC_T - 1) / TC_T, (Co + TC_T - 1) / TC_T);
  pointwise_bwd_reduce_tc<TX, MODE><<<grid, TC_THREADS, smem, stream>>>(
      (const TX*)x, p, (const bf16*)W, (const bf16*)dy, part_dw, part_dcb, part_dg, part_db, B,
      C, Co, S, lgP, chunk_rows, w_vec(W, Co));
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_reduce_tc(const void* x, Norm p, const void* W, const void* dy, float* part_dw,
                     float* part_dcb, float* part_dg, float* part_db, int B, int C, int Co, int S,
                     int chunk_rows, cudaStream_t stream) {
  int lgP = 6;
  switch (tc_mode(x, sizeof(TX), dy, C, Co, S, &lgP)) {
    case kModeS:
      return launch_reduce_tc_mode<TX, kModeS>(x, p, W, dy, part_dw, part_dcb, part_dg, part_db,
                                               B, C, Co, S, lgP, chunk_rows, stream);
    case kModeB:
      return launch_reduce_tc_mode<TX, kModeB>(x, p, W, dy, part_dw, part_dcb, part_dg, part_db,
                                               B, C, Co, S, lgP, chunk_rows, stream);
    default:
      return launch_reduce_tc_mode<TX, kModeG>(x, p, W, dy, part_dw, part_dcb, part_dg, part_db,
                                               B, C, Co, S, lgP, chunk_rows, stream);
  }
}

template <typename TX, int MODE, int NR>
int launch_dx_tc_mode(const void* x, Norm p, const void* W, const void* dy, const float* dg,
                      const float* db, void* dx, int B, int C, int Co, int S, int lgP,
                      cudaStream_t stream) {
  const size_t smem = DxSmem<TX>::bytes(Co);
  int wave = 0;
  const cudaError_t err = prepare<pointwise_bwd_dx_tc<TX, MODE, NR>>(smem, TC_THREADS, &wave);
  if (err != cudaSuccess) return (int)err;
  const int c_tiles = (C + TC_T - 1) / TC_T, tiles = (B * S + NR - 1) / NR;
  const int per_c = wave / c_tiles < 1 ? 1 : wave / c_tiles;
  const dim3 grid(tiles < per_c ? tiles : per_c, c_tiles);
  pointwise_bwd_dx_tc<TX, MODE, NR><<<grid, TC_THREADS, smem, stream>>>(
      (const TX*)x, p, (const bf16*)W, (const bf16*)dy, dg, db, (TX*)dx, B, C, Co, S, lgP,
      w_vec(W, Co));
  return (int)cudaGetLastError();
}

template <typename TX, int NR>
int launch_dx_tc_rows(const void* x, Norm p, const void* W, const void* dy, const float* dg,
                      const float* db, void* dx, int B, int C, int Co, int S,
                      cudaStream_t stream) {
  int lgP = 6;
  int mode = tc_mode(x, sizeof(TX), dy, C, Co, S, &lgP, NR);
  if ((uintptr_t)dx % 16 != 0) mode = kModeG;  // dx goes out in x's layout
  switch (mode) {
    case kModeS:
      return launch_dx_tc_mode<TX, kModeS, NR>(x, p, W, dy, dg, db, dx, B, C, Co, S, lgP, stream);
    case kModeB:
      return launch_dx_tc_mode<TX, kModeB, NR>(x, p, W, dy, dg, db, dx, B, C, Co, S, lgP, stream);
    default:
      return launch_dx_tc_mode<TX, kModeG, NR>(x, p, W, dy, dg, db, dx, B, C, Co, S, lgP, stream);
  }
}

template <typename TX>
int launch_dx_tc(const void* x, Norm p, const void* W, const void* dy, const float* dg,
                 const float* db, void* dx, int B, int C, int Co, int S, int rows,
                 cudaStream_t stream) {
  switch (rows) {
    case 64:
      return launch_dx_tc_rows<TX, 64>(x, p, W, dy, dg, db, dx, B, C, Co, S, stream);
    case 32:
      return launch_dx_tc_rows<TX, 32>(x, p, W, dy, dg, db, dx, B, C, Co, S, stream);
    case 16:
      return launch_dx_tc_rows<TX, 16>(x, p, W, dy, dg, db, dx, B, C, Co, S, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The lanes that share a channel in pointwise_stats_kernel (a power of two,
// at most 32 and at most the channel's groups of G elements in one b)
int stats_lanes(int S, int G) {
  int tpc = 1;
  while (tpc < 32 && 2 * tpc <= S / G) tpc *= 2;
  return tpc;
}

template <typename TX>
int launch_stats(const void* x, float* part_mean, float* part_m2, int B, int C, int S,
                 int b_per_chunk, cudaStream_t stream) {
  constexpr int VE = 16 / sizeof(TX);
  const int G = S % VE == 0 ? VE : 1, tpc = stats_lanes(S, G), per_block = ST_THREADS / tpc;
  const dim3 grid((B + b_per_chunk - 1) / b_per_chunk, (C + per_block - 1) / per_block);
  const bool vec = (uintptr_t)x % 16 == 0;
  if (G == VE) {
    pointwise_stats_kernel<TX, VE><<<grid, ST_THREADS, 0, stream>>>(
        (const TX*)x, part_mean, part_m2, B, C, S, tpc, b_per_chunk, vec);
  } else {
    pointwise_stats_kernel<TX, 1><<<grid, ST_THREADS, 0, stream>>>(
        (const TX*)x, part_mean, part_m2, B, C, S, tpc, b_per_chunk, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. x_dtype (x, dx) and w_dtype (W, y, dy): 0 = float32,
// 1 = bfloat16. A bfloat16 W goes to the tensor-core entry points
// (pointwise_fwd_tc, pointwise_bwd_reduce_tc, pointwise_bwd_dx_tc):
// pointwise_fwd, pointwise_bwd_reduce and pointwise_bwd_dx take float32 W
// only. Each returns a cudaError_t as
// int: 0 on success, the launch error otherwise.
// ---------------------------------------------------------------------------

#define X_DISPATCH(XD, ...)            \
  {                                    \
    if ((XD) == 0) {                   \
      using TX = float;                \
      return __VA_ARGS__;              \
    }                                  \
    if ((XD) == 1) {                   \
      using TX = __nv_bfloat16;        \
      return __VA_ARGS__;              \
    }                                  \
    return (int)cudaErrorInvalidValue; \
  }

extern "C" int pointwise_fwd(const void* x, const float* gamma, const float* beta,
                             const float* mean, const float* inv, const void* W,
                             const float* cb, void* y, int B, int C, int Co, int S, int x_dtype,
                             int w_dtype, cudaStream_t stream) {
  if (bad_shape(B, C, Co, S) || w_dtype != 0) return (int)cudaErrorInvalidValue;
  const Norm p{gamma, beta, mean, inv};
  X_DISPATCH(x_dtype, launch_fwd<TX>(x, p, W, cb, y, B, C, Co, S, stream))
}

// y in bfloat16 from a bfloat16 W, C <= TC_MAX_C
extern "C" int pointwise_fwd_tc(const void* x, const float* gamma, const float* beta,
                                const float* mean, const float* inv, const void* W,
                                const float* cb, void* y, int B, int C, int Co, int S,
                                int x_dtype, cudaStream_t stream) {
  if (bad_shape(B, C, Co, S) || C > TC_MAX_C) return (int)cudaErrorInvalidValue;
  const Norm p{gamma, beta, mean, inv};
  X_DISPATCH(x_dtype, launch_fwd_tc<TX>(x, p, W, cb, y, B, C, Co, S, stream))
}

extern "C" int pointwise_bwd_reduce(const void* x, const float* gamma, const float* beta,
                                    const float* mean, const float* inv, const void* W,
                                    const void* dy, float* part_dw, float* part_dcb,
                                    float* part_dg, float* part_db, int B, int C, int Co, int S,
                                    int chunk_rows, int x_dtype, int w_dtype,
                                    cudaStream_t stream) {
  if (bad_shape(B, C, Co, S) || w_dtype != 0 || chunk_rows < AT || chunk_rows % AT != 0)
    return (int)cudaErrorInvalidValue;
  const Norm p{gamma, beta, mean, inv};
  X_DISPATCH(x_dtype, launch_reduce<TX>(x, p, W, dy, part_dw, part_dcb, part_dg, part_db, B, C,
                                        Co, S, chunk_rows, stream))
}

// Pass A's partials from a bfloat16 W and dy, chunk_rows a multiple of 64.
// With one chunk, part_dw and part_dcb receive dW and dcb themselves.
extern "C" int pointwise_bwd_reduce_tc(const void* x, const float* gamma, const float* beta,
                                       const float* mean, const float* inv, const void* W,
                                       const void* dy, float* part_dw, float* part_dcb,
                                       float* part_dg, float* part_db, int B, int C, int Co,
                                       int S, int chunk_rows, int x_dtype, cudaStream_t stream) {
  if (bad_shape(B, C, Co, S) || chunk_rows < TC_T || chunk_rows % TC_T != 0)
    return (int)cudaErrorInvalidValue;
  const Norm p{gamma, beta, mean, inv};
  X_DISPATCH(x_dtype, launch_reduce_tc<TX>(x, p, W, dy, part_dw, part_dcb, part_dg, part_db, B,
                                           C, Co, S, chunk_rows, stream))
}

// With chunks == 1, dW and dcb are their one partial already (the caller
// reads them there): only dgamma and dbeta are summed, over the output tiles.
extern "C" int pointwise_bwd_finalize(const float* part_dw, const float* part_dcb,
                                      const float* part_dg, const float* part_db, float* dW,
                                      float* dcb, float* dg, float* db, int C, int Co,
                                      int chunks, int o_tiles, cudaStream_t stream) {
  if (C < 1 || C > kMaxC || Co < 1 || Co > kMaxC || chunks < 1 || o_tiles < 1)
    return (int)cudaErrorInvalidValue;
  const long long first = chunks == 1 ? (long long)C * Co + Co : 0;
  const long long outputs = (long long)C * Co + Co + 2LL * C - first;
  const unsigned blocks = (unsigned)((outputs + kThreads - 1) / kThreads);
  pointwise_bwd_finalize_kernel<<<blocks, kThreads, 0, stream>>>(
      part_dw, part_dcb, part_dg, part_db, dW, dcb, dg, db, C, Co, chunks, o_tiles, first);
  return (int)cudaGetLastError();
}

extern "C" int pointwise_bwd_dx(const void* x, const float* gamma, const float* beta,
                                const float* mean, const float* inv, const void* W,
                                const void* dy, const float* dg, const float* db, void* dx, int B,
                                int C, int Co, int S, int x_dtype, int w_dtype,
                                cudaStream_t stream) {
  if (bad_shape(B, C, Co, S) || w_dtype != 0) return (int)cudaErrorInvalidValue;
  const Norm p{gamma, beta, mean, inv};
  X_DISPATCH(x_dtype, launch_dx<TX>(x, p, W, dy, dg, db, dx, B, C, Co, S, stream))
}

// Pass B from a bfloat16 W and dy, Co <= TC_MAX_C (W's 64-channel slice
// stays in shared memory); rows: the row tile, 64, 32 or 16
extern "C" int pointwise_bwd_dx_tc(const void* x, const float* gamma, const float* beta,
                                   const float* mean, const float* inv, const void* W,
                                   const void* dy, const float* dg, const float* db, void* dx,
                                   int B, int C, int Co, int S, int rows, int x_dtype,
                                   cudaStream_t stream) {
  if (bad_shape(B, C, Co, S) || Co > TC_MAX_C) return (int)cudaErrorInvalidValue;
  const Norm p{gamma, beta, mean, inv};
  X_DISPATCH(x_dtype, launch_dx_tc<TX>(x, p, W, dy, dg, db, dx, B, C, Co, S, rows, stream))
}

// The statistics' partials: per (chunk of b_per_chunk whole b, channel) the
// chunk's mean and M2, part_mean and part_m2 [chunks, C] float32
extern "C" int pointwise_stats(const void* x, float* part_mean, float* part_m2, int B, int C,
                               int S, int b_per_chunk, int x_dtype, cudaStream_t stream) {
  if (B < 1 || C < 1 || S < 1 || b_per_chunk < 1) return (int)cudaErrorInvalidValue;
  X_DISPATCH(x_dtype, launch_stats<TX>(x, part_mean, part_m2, B, C, S, b_per_chunk, stream))
}

// mean, var (biased), inv = 1 / sqrt(var + eps) [C] from the partials; with
// running_mean and running_var (else null), their update in place:
// r <- one_minus_m * r + m * stat, the variance times unbias = n / (n - 1)
extern "C" int pointwise_stats_finalize(const float* part_mean, const float* part_m2,
                                        float* mean, float* var, float* inv,
                                        float* running_mean, float* running_var, int B, int C,
                                        int S, int b_per_chunk, float eps, float m,
                                        float one_minus_m, float unbias, cudaStream_t stream) {
  if (B < 1 || C < 1 || S < 1 || b_per_chunk < 1 || (running_mean == nullptr) != (running_var == nullptr))
    return (int)cudaErrorInvalidValue;
  const int chunks = (B + b_per_chunk - 1) / b_per_chunk, per_block = ST_THREADS / 32;
  pointwise_stats_finalize_kernel<<<(C + per_block - 1) / per_block, ST_THREADS, 0, stream>>>(
      part_mean, part_m2, mean, var, inv, running_mean, running_var, B, C, S, b_per_chunk, chunks,
      eps, m, one_minus_m, unbias);
  return (int)cudaGetLastError();
}
