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
// xhat and h are recomputed from x in every kernel and never stored.
//
// What bounds it on this card: the products are 2 * R * C * Co operations
// over R * (C + Co) elements, 64-320 operations per element read, so on
// tensor cores in bf16 the bytes would bound them. These kernels run the
// products on the CUDA cores in float32 (tensor cores are later work), so
// float32 FMAs, and the shared-memory loads that feed them, bound them. At
// the flagship a train step's 32 calls are ~68 GFLOP forward and three times
// that backward. What the design does:
//
//  * No permutation to rows x C: the kernels index [B, C, S] directly. A
//    row tile's loads and stores run along s, contiguous where S >= 16; the
//    row offset b * K * S + s is computed once per tile.
//  * 256 threads as 16 x 16, each with a 4 x 8 (forward, pass B) or 4 x 4
//    (pass A) micro-tile of sums in registers. Operand tiles are staged in
//    shared memory as float, rows padded by one float, so that row-wise and
//    transposed reads both fall in distinct banks. C and Co (up to 320 at
//    the flagship) are tiled: W at 320 x 320 would not fit an SM whole.
//  * pointwise_fwd: one block per (128 rows, 64 outputs), looping over the
//    channels in chunks of 32; x is normalised, rectified and rounded to T
//    as it is staged.
//  * pointwise_bwd_dx: one block per (128 rows, 64 channels), looping over
//    the outputs in chunks of 32; the epilogue reloads x for xhat and the
//    mask.
//  * The TPU carries pass A's sums across a sequential grid in VMEM; blocks
//    here run in no order. pointwise_bwd_reduce gives each block one
//    (row chunk, 64 channels, 64 outputs) tile and writes its partial sums
//    to scratch, and pointwise_bwd_finalize sums each output's partials in a
//    fixed order. No atomics: two runs give equal gradients. dh over one
//    output tile is a partial of the full dh; the mask and the sums after it
//    are linear in dh, so dgamma and dbeta are summed over output tiles as
//    well, and each product is computed once.
//  * Long sums: each 64-row sub-tile's partial joins the block's running dW
//    and dcb by compensated (Kahan) addition, and the finalize sums the
//    chunks the same way (a float32 running sum over 32768 rows lost ~1e-4
//    in K2; here rows reach 2^20).
//  * xhat and gamma * xhat + beta round each operation on its own
//    (__fmul_rn, __fadd_rn: no FMA contraction), as PyTorch's elementwise
//    ops do, so h and its bf16 rounding equal the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
pointwise_fwd_kernel(const TX* __restrict__ x, Norm p, const TW* __restrict__ W,
                     const float* __restrict__ cb, TW* __restrict__ y, int R, int C, int Co,
                     int S) {
  __shared__ float ws[FK * (FP + 1)];  // ws[k][pp] = W[c0 + k, o0 + pp]
  __shared__ float hs[FK * (FN + 1)];  // hs[k][q] = round_T(h) of row n0 + q, channel c0 + k
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
      ws[k * (FP + 1) + pp] = (c < C && o < Co) ? to_f<TW>(W[(long long)c * Co + o]) : 0.0f;
    }
    for (int k = tid / FN; k < FK; k += kThreads / FN) {
      const int c = c0 + k;
      float h = 0.0f;
      if (c < C && xrow >= 0) {
        const float xh = norm_xhat(to_f<TX>(x[xrow + (long long)c * S]), p, c);
        h = round_to<TW>(relu(norm_pre(xh, __ldg(p.gamma + c), __ldg(p.beta + c))));
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
      if (o < Co) y[yrow + (long long)o * S] = from_f<TW>(acc[i][j] + __ldg(cb + o));
    }
  }
}

// ---------------------------------------------------------------------------
// backward pass B: dx
// ---------------------------------------------------------------------------

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
pointwise_bwd_dx_kernel(const TX* __restrict__ x, Norm p, const TW* __restrict__ W,
                        const TW* __restrict__ dy, const float* __restrict__ dg,
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
      ws[k * (FP + 1) + pp] = (c < C && o < Co) ? to_f<TW>(W[(long long)c * Co + o]) : 0.0f;
    }
    for (int k = tid / FN; k < FK; k += kThreads / FN) {
      const int o = o0 + k;
      ds[k * (FN + 1) + q] =
          (o < Co && dyrow >= 0) ? to_f<TW>(dy[dyrow + (long long)o * S]) : 0.0f;
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

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
pointwise_bwd_reduce_kernel(const TX* __restrict__ x, Norm p, const TW* __restrict__ W,
                            const TW* __restrict__ dy, float* __restrict__ part_dw,
                            float* __restrict__ part_dcb, float* __restrict__ part_dg,
                            float* __restrict__ part_db, int R, int C, int Co, int S,
                            int chunk_rows) {
  extern __shared__ float smem[];
  float* ws = smem;          // ws[o][c] = W[c0 + c, o0 + o]
  float* xs = ws + AT * AL;  // xs[n][c] = xhat
  float* hs = xs + AT * AL;  // hs[n][c] = round_T(h)
  float* ds = hs + AT * AL;  // ds[n][o] = dy
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int chunk = blockIdx.x, c0 = blockIdx.y * AT, o0 = blockIdx.z * AT;
  const int n_begin = chunk * chunk_rows;
  const int n_end = min(R, n_begin + chunk_rows);

  for (int idx = tid; idx < AT * AT; idx += kThreads) {
    const int o = idx / AT, c = idx - o * AT;
    ws[o * AL + c] = (c0 + c < C && o0 + o < Co)
                         ? to_f<TW>(W[(long long)(c0 + c) * Co + o0 + o]) : 0.0f;
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
        h = round_to<TW>(relu(norm_pre(xh, __ldg(p.gamma + c), __ldg(p.beta + c))));
      }
      xs[q * AL + k] = xh;
      hs[q * AL + k] = h;
      ds[q * AL + k] = (o < Co && row_ok) ? to_f<TW>(dy[dyrow + (long long)o * S]) : 0.0f;
    }
    __syncthreads();

    // dW[c, o] += sum_n round_T(h)[n, c] dy[n, o]
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
// partials in order (Kahan): one thread per output.
__global__ void __launch_bounds__(kThreads)
pointwise_bwd_finalize_kernel(const float* __restrict__ part_dw, const float* __restrict__ part_dcb,
                              const float* __restrict__ part_dg, const float* __restrict__ part_db,
                              float* __restrict__ dW, float* __restrict__ dcb,
                              float* __restrict__ dg, float* __restrict__ db, int C, int Co,
                              int chunks, int o_tiles) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
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
// launchers
// ---------------------------------------------------------------------------

constexpr size_t kReduceSmem = sizeof(float) * 4 * AT * AL;  // 66,560 bytes

bool bad_shape(int B, int C, int Co, int S) {
  return B < 1 || S < 1 || C < 1 || C > kMaxC || Co < 1 || Co > kMaxC;
}

template <typename TX, typename TW>
int launch_fwd(const void* x, Norm p, const void* W, const float* cb, void* y, int B, int C,
               int Co, int S, cudaStream_t stream) {
  const int R = B * S;
  const dim3 grid((R + FN - 1) / FN, (Co + FP - 1) / FP);
  pointwise_fwd_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      (const TX*)x, p, (const TW*)W, cb, (TW*)y, R, C, Co, S);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch_dx(const void* x, Norm p, const void* W, const void* dy, const float* dg,
              const float* db, void* dx, int B, int C, int Co, int S, cudaStream_t stream) {
  const int R = B * S;
  const dim3 grid((R + FN - 1) / FN, (C + FP - 1) / FP);
  pointwise_bwd_dx_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      (const TX*)x, p, (const TW*)W, (const TW*)dy, dg, db, (TX*)dx, R, C, Co, S);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch_reduce(const void* x, Norm p, const void* W, const void* dy, float* part_dw,
                  float* part_dcb, float* part_dg, float* part_db, int B, int C, int Co, int S,
                  int chunk_rows, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(pointwise_bwd_reduce_kernel<TX, TW>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)kReduceSmem);
  if (err != cudaSuccess) return (int)err;
  const int R = B * S;
  const dim3 grid((R + chunk_rows - 1) / chunk_rows, (C + AT - 1) / AT, (Co + AT - 1) / AT);
  pointwise_bwd_reduce_kernel<TX, TW><<<grid, kThreads, kReduceSmem, stream>>>(
      (const TX*)x, p, (const TW*)W, (const TW*)dy, part_dw, part_dcb, part_dg, part_db, R, C,
      Co, S, chunk_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points. x_dtype (x, dx) and w_dtype (W, y, dy): 0 = float32,
// 1 = bfloat16. Each returns a cudaError_t as int: 0 on success, the launch
// error otherwise.
// ---------------------------------------------------------------------------

#define PW_DISPATCH(XD, WD, ...)                                                        \
  {                                                                                     \
    if ((XD) == 0 && (WD) == 0) {                                                       \
      using TX = float;                                                                 \
      using TW = float;                                                                 \
      return __VA_ARGS__;                                                               \
    }                                                                                   \
    if ((XD) == 0 && (WD) == 1) {                                                       \
      using TX = float;                                                                 \
      using TW = __nv_bfloat16;                                                         \
      return __VA_ARGS__;                                                               \
    }                                                                                   \
    if ((XD) == 1 && (WD) == 0) {                                                       \
      using TX = __nv_bfloat16;                                                         \
      using TW = float;                                                                 \
      return __VA_ARGS__;                                                               \
    }                                                                                   \
    if ((XD) == 1 && (WD) == 1) {                                                       \
      using TX = __nv_bfloat16;                                                         \
      using TW = __nv_bfloat16;                                                         \
      return __VA_ARGS__;                                                               \
    }                                                                                   \
    return (int)cudaErrorInvalidValue;                                                  \
  }

extern "C" int pointwise_fwd(const void* x, const float* gamma, const float* beta,
                             const float* mean, const float* inv, const void* W,
                             const float* cb, void* y, int B, int C, int Co, int S, int x_dtype,
                             int w_dtype, cudaStream_t stream) {
  if (bad_shape(B, C, Co, S)) return (int)cudaErrorInvalidValue;
  const Norm p{gamma, beta, mean, inv};
  PW_DISPATCH(x_dtype, w_dtype, launch_fwd<TX, TW>(x, p, W, cb, y, B, C, Co, S, stream))
}

extern "C" int pointwise_bwd_reduce(const void* x, const float* gamma, const float* beta,
                                    const float* mean, const float* inv, const void* W,
                                    const void* dy, float* part_dw, float* part_dcb,
                                    float* part_dg, float* part_db, int B, int C, int Co, int S,
                                    int chunk_rows, int x_dtype, int w_dtype,
                                    cudaStream_t stream) {
  if (bad_shape(B, C, Co, S) || chunk_rows < AT || chunk_rows % AT != 0)
    return (int)cudaErrorInvalidValue;
  const Norm p{gamma, beta, mean, inv};
  PW_DISPATCH(x_dtype, w_dtype,
              launch_reduce<TX, TW>(x, p, W, dy, part_dw, part_dcb, part_dg, part_db, B, C, Co,
                                    S, chunk_rows, stream))
}

extern "C" int pointwise_bwd_finalize(const float* part_dw, const float* part_dcb,
                                      const float* part_dg, const float* part_db, float* dW,
                                      float* dcb, float* dg, float* db, int C, int Co,
                                      int chunks, int o_tiles, cudaStream_t stream) {
  if (C < 1 || C > kMaxC || Co < 1 || Co > kMaxC || chunks < 1 || o_tiles < 1)
    return (int)cudaErrorInvalidValue;
  const long long outputs = (long long)C * Co + Co + 2LL * C;
  const unsigned blocks = (unsigned)((outputs + kThreads - 1) / kThreads);
  pointwise_bwd_finalize_kernel<<<blocks, kThreads, 0, stream>>>(
      part_dw, part_dcb, part_dg, part_db, dW, dcb, dg, db, C, Co, chunks, o_tiles);
  return (int)cudaGetLastError();
}

extern "C" int pointwise_bwd_dx(const void* x, const float* gamma, const float* beta,
                                const float* mean, const float* inv, const void* W,
                                const void* dy, const float* dg, const float* db, void* dx, int B,
                                int C, int Co, int S, int x_dtype, int w_dtype,
                                cudaStream_t stream) {
  if (bad_shape(B, C, Co, S)) return (int)cudaErrorInvalidValue;
  const Norm p{gamma, beta, mean, inv};
  PW_DISPATCH(x_dtype, w_dtype,
              launch_dx<TX, TW>(x, p, W, dy, dg, db, dx, B, C, Co, S, stream))
}
