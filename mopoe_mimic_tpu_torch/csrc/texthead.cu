// Fused word-text vocab head, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// mopoe_mimic_tpu/ops/pallas_texthead.py (:72, :88), launched by
// `_core_fwd_raw` (:137) and `_core_bwd` (:170). For decoder features
// h [R, C], the head W [C, V] (both float32, or both bfloat16), bias b [V]
// (float32) and target ids t [R] (int32):
//
//   logits = h @ W + b                       (float32 accumulation)
//   lse    = logsumexp(logits)               (per row)
//   lp     = logits[t] - lse
//
// and, from the saved lse and the upstream gradient g [R] (float32),
//
//   dlog = ((onehot(t) - exp(logits - lse)) * g), rounded to h's dtype
//   dh   = dlog @ W^T                        (stored in h's dtype)
//   dW   = h^T @ dlog,  db = sum_r dlog      (float32)
//
// without ever writing the [R, V] logits to device memory: at the flagship
// (R = 256 * 128 = 32768, C = 64, V = 3517) they would be 461 MB in
// float32, written and read several times by the unfused head.
//
// What bounds it on this card: arithmetic. The forward is 2*R*C*V = 14.7
// GFLOP and the backward recomputes the logits twice and adds two more
// products of the same size (about 3x the forward), against ~4 MB of
// inputs. These kernels run the products on the CUDA cores in float32
// (a tensor-core wgmma version is later work). What the design does:
//
//  * texthead_fwd: one block per tile of 128 rows. The h tile is staged
//    once in shared memory (C <= 128 is small); the block walks the
//    vocabulary in tiles of 64 columns of W through shared memory. Each
//    thread owns an 8 x 4 micro-tile of logits and keeps, per row, an
//    online max and sum (a running logsumexp) over the columns it sees and
//    the target's logit when that column passes; the 16 threads that share
//    a row combine theirs with warp shuffles at the end. The ragged last
//    vocabulary tile and the ragged last row tile are masked in the kernel
//    (no -1e30 bias padding as on the TPU, no row padding).
//  * The TPU backward carries dW and db across a sequential grid in VMEM.
//    Blocks here run in no order, so the backward is two kernels, each with
//    one owner per output and no atomics (two runs give equal gradients):
//    - texthead_bwd_dh: one block per tile of 128 rows; for each vocabulary
//      tile it recomputes the logits, forms dlog in shared memory and
//      accumulates dh = dlog @ W^T in registers;
//    - texthead_bwd_dw: one block per tile of 32 vocabulary columns (110
//      blocks at V = 3517 for the 132 SMs); it loops over all rows in
//      chunks of 64, recomputes that chunk's logits and dlog, and
//      accumulates dW[:, tile] = h^T @ dlog and db[tile] in registers,
//      adding each chunk's partial sums to the running sums by
//      compensated (Kahan) addition, so that a sum over 32768 rows in one
//      thread keeps float32 accuracy.
//    The saved lse makes every vocabulary tile independent: the softmax of
//    one column needs no other column.
//  * Shared-memory rows are padded by one float so that the transposed
//    reads of the second products fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define TH_THREADS 256
#define TH_MAX_C 128
#define TH_FULL_MASK 0xffffffffu

// forward and dh: 128-row tiles (8 rows per thread), 64-column vocab tiles
#define TH_RM 8
#define TH_CN 4
#define TH_TR (16 * TH_RM)
#define TH_TV (16 * TH_CN)
// dW: 64-row chunks (4 rows per thread), 32-column vocab tiles
#define TW_RM 4
#define TW_CN 2
#define TW_TR (16 * TW_RM)
#define TW_TV (16 * TW_CN)

template <typename T>
__device__ __forceinline__ float load_f(const T* p, long long i);
template <>
__device__ __forceinline__ float load_f<float>(const float* p, long long i) { return p[i]; }
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__device__ __forceinline__ T store_t(float x);
template <>
__device__ __forceinline__ float store_t<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_t<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast does
}

// x rounded to T's precision and read back as float
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// h rows [r0, r0 + TR) → hs[k * (TR + 1) + r] as float, zero beyond R
template <typename T, int TR>
__device__ __forceinline__ void load_h_tile(float* hs, const T* __restrict__ h, long long r0,
                                            int R, int C) {
  for (int idx = threadIdx.x; idx < TR * C; idx += TH_THREADS) {
    const int r = idx / C, k = idx - r * C;
    hs[k * (TR + 1) + r] = (r0 + r < R) ? load_f<T>(h, (r0 + r) * C + k) : 0.0f;
  }
}

// W columns [v0, v0 + TV) → ws[k * (TV + 1) + c] and b → bs[c], zero beyond V
template <typename T, int TV>
__device__ __forceinline__ void load_w_tile(float* ws, float* bs, const T* __restrict__ W,
                                            const float* __restrict__ b, int v0, int C, int V) {
  for (int idx = threadIdx.x; idx < TV * C; idx += TH_THREADS) {
    const int k = idx / TV, c = idx - k * TV;
    ws[k * (TV + 1) + c] = (v0 + c < V) ? load_f<T>(W, (long long)k * V + v0 + c) : 0.0f;
  }
  for (int c = threadIdx.x; c < TV; c += TH_THREADS) bs[c] = (v0 + c < V) ? b[v0 + c] : 0.0f;
}

// sum += x with the running compensation comp (Kahan); no fast-math, so
// the compiler keeps the order
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// The thread's RM x CN micro-tile of logits: rows ty * RM + i, columns
// tx + 16 * j of the tile, summed over k in order, then + bias.
template <int RM, int CN>
__device__ __forceinline__ void tile_logits(const float* hs, const float* ws, const float* bs,
                                            int C, int ty, int tx, float (&acc)[RM][CN]) {
  constexpr int TR = 16 * RM, TV = 16 * CN;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;
  for (int k = 0; k < C; ++k) {
    float a[RM], w[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = hs[k * (TR + 1) + ty * RM + i];
#pragma unroll
    for (int j = 0; j < CN; ++j) w[j] = ws[k * (TV + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] += bs[tx + 16 * j];
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(TH_THREADS)
texthead_fwd_kernel(const T* __restrict__ h, const T* __restrict__ W, const float* __restrict__ b,
                    const int* __restrict__ tgt, float* __restrict__ lp, float* __restrict__ lse,
                    int R, int C, int V) {
  extern __shared__ float smem[];
  float* hs = smem;                         // [C][TH_TR + 1]
  float* ws = hs + C * (TH_TR + 1);         // [C][TH_TV + 1]
  float* bs = ws + C * (TH_TV + 1);         // [TH_TV]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long r0 = (long long)blockIdx.x * TH_TR;

  load_h_tile<T, TH_TR>(hs, h, r0, R, C);

  float run_max[TH_RM], run_sum[TH_RM], tgt_logit[TH_RM];
  int t_row[TH_RM];
#pragma unroll
  for (int i = 0; i < TH_RM; ++i) {
    const long long r = r0 + ty * TH_RM + i;
    run_max[i] = -INFINITY;
    run_sum[i] = 0.0f;
    tgt_logit[i] = 0.0f;
    t_row[i] = (r < R) ? tgt[r] : -1;
  }

  for (int v0 = 0; v0 < V; v0 += TH_TV) {
    __syncthreads();  // the previous tile's readers are done
    load_w_tile<T, TH_TV>(ws, bs, W, b, v0, C, V);
    __syncthreads();
    float acc[TH_RM][TH_CN];
    tile_logits<TH_RM, TH_CN>(hs, ws, bs, C, ty, tx, acc);
#pragma unroll
    for (int j = 0; j < TH_CN; ++j) {
      const int col = v0 + tx + 16 * j;
      if (col >= V) continue;
#pragma unroll
      for (int i = 0; i < TH_RM; ++i) {
        const float x = acc[i][j];
        if (col == t_row[i]) tgt_logit[i] = x;
        if (x > run_max[i]) {
          run_sum[i] = run_sum[i] * expf(run_max[i] - x) + 1.0f;
          run_max[i] = x;
        } else {
          run_sum[i] += expf(x - run_max[i]);
        }
      }
    }
  }

  // combine the 16 threads of a row (lanes tx = 0..15 of one half-warp)
#pragma unroll
  for (int i = 0; i < TH_RM; ++i) {
    float m = run_max[i], s = run_sum[i], tl = tgt_logit[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(TH_FULL_MASK, m, off);
      const float s2 = __shfl_xor_sync(TH_FULL_MASK, s, off);
      const float t2 = __shfl_xor_sync(TH_FULL_MASK, tl, off);
      const float mn = fmaxf(m, m2);
      const float a = (m == -INFINITY) ? 0.0f : s * expf(m - mn);
      const float c = (m2 == -INFINITY) ? 0.0f : s2 * expf(m2 - mn);
      s = a + c;
      m = mn;
      tl += t2;  // only one lane holds the target's logit; the rest hold 0
    }
    const long long r = r0 + ty * TH_RM + i;
    if (tx == 0 && r < R) {
      const float l = m + logf(s);
      lse[r] = l;
      lp[r] = tl - l;
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dh
// ---------------------------------------------------------------------------

template <typename T, int CJ>
__global__ void __launch_bounds__(TH_THREADS)
texthead_bwd_dh_kernel(const T* __restrict__ h, const T* __restrict__ W,
                       const float* __restrict__ b, const int* __restrict__ tgt,
                       const float* __restrict__ lse, const float* __restrict__ g,
                       T* __restrict__ dh, int R, int C, int V) {
  extern __shared__ float smem[];
  float* hs = smem;                         // [C][TH_TR + 1]
  float* ws = hs + C * (TH_TR + 1);         // [C][TH_TV + 1]
  float* bs = ws + C * (TH_TV + 1);         // [TH_TV]
  float* ds = bs + TH_TV;                   // [TH_TR][TH_TV + 1] dlog tile
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long r0 = (long long)blockIdx.x * TH_TR;

  load_h_tile<T, TH_TR>(hs, h, r0, R, C);

  float row_lse[TH_RM], row_g[TH_RM];
  int t_row[TH_RM];
#pragma unroll
  for (int i = 0; i < TH_RM; ++i) {
    const long long r = r0 + ty * TH_RM + i;
    const bool ok = r < R;
    row_lse[i] = ok ? lse[r] : 0.0f;
    row_g[i] = ok ? g[r] : 0.0f;
    t_row[i] = ok ? tgt[r] : -2;  // -2: the row is past R
  }
  // dh accumulators: rows ty * TH_RM + i, channels tx + 16 * j
  float acc_dh[TH_RM][CJ];
#pragma unroll
  for (int i = 0; i < TH_RM; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc_dh[i][j] = 0.0f;

  for (int v0 = 0; v0 < V; v0 += TH_TV) {
    __syncthreads();
    load_w_tile<T, TH_TV>(ws, bs, W, b, v0, C, V);
    __syncthreads();
    float acc[TH_RM][TH_CN];
    tile_logits<TH_RM, TH_CN>(hs, ws, bs, C, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < TH_RM; ++i) {
#pragma unroll
      for (int j = 0; j < TH_CN; ++j) {
        const int col = v0 + tx + 16 * j;
        float d = 0.0f;
        if (col < V && t_row[i] != -2) {
          const float p = expf(acc[i][j] - row_lse[i]);
          d = round_to<T>(((col == t_row[i] ? 1.0f : 0.0f) - p) * row_g[i]);
        }
        ds[(ty * TH_RM + i) * (TH_TV + 1) + tx + 16 * j] = d;
      }
    }
    __syncthreads();
    // dh[r, c] += sum_v dlog[r, v] * W[c, v]
    for (int v = 0; v < TH_TV; ++v) {
      float dv[TH_RM], wv[CJ];
#pragma unroll
      for (int i = 0; i < TH_RM; ++i) dv[i] = ds[(ty * TH_RM + i) * (TH_TV + 1) + v];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j;
        wv[j] = (c < C) ? ws[c * (TH_TV + 1) + v] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < TH_RM; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc_dh[i][j] = fmaf(dv[i], wv[j], acc_dh[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TH_RM; ++i) {
    const long long r = r0 + ty * TH_RM + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = tx + 16 * j;
      if (c < C) dh[r * C + c] = store_t<T>(acc_dh[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dW, db
// ---------------------------------------------------------------------------

template <typename T, int CJ>
__global__ void __launch_bounds__(TH_THREADS)
texthead_bwd_dw_kernel(const T* __restrict__ h, const T* __restrict__ W,
                       const float* __restrict__ b, const int* __restrict__ tgt,
                       const float* __restrict__ lse, const float* __restrict__ g,
                       float* __restrict__ dW, float* __restrict__ db, int R, int C, int V) {
  extern __shared__ float smem[];
  float* ws = smem;                         // [C][TW_TV + 1], fixed for the block
  float* bs = ws + C * (TW_TV + 1);         // [TW_TV]
  float* hs = bs + TW_TV;                   // [C][TW_TR + 1], one row chunk
  float* ds = hs + C * (TW_TR + 1);         // [TW_TR][TW_TV + 1] dlog chunk
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int v0 = blockIdx.x * TW_TV;

  load_w_tile<T, TW_TV>(ws, bs, W, b, v0, C, V);

  // dW accumulators: channels ty + 16 * i, columns tx + 16 * j; db for the
  // columns tx + 16 * j is summed by the threads with ty == 0. Each chunk's
  // partial sums join the running sums by compensated (Kahan) addition: a
  // plain running sum over R = 32768 rows loses ~1e-4 absolute at the
  // flagship, where a blocked GEMM loses ~1e-6.
  float acc_dw[CJ][TW_CN], comp_dw[CJ][TW_CN], acc_db[TW_CN], comp_db[TW_CN];
#pragma unroll
  for (int j = 0; j < TW_CN; ++j) {
    acc_db[j] = comp_db[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < CJ; ++i) acc_dw[i][j] = comp_dw[i][j] = 0.0f;
  }

  for (long long r0 = 0; r0 < R; r0 += TW_TR) {
    __syncthreads();  // the previous chunk's readers are done
    load_h_tile<T, TW_TR>(hs, h, r0, R, C);
    __syncthreads();
    float acc[TW_RM][TW_CN];
    tile_logits<TW_RM, TW_CN>(hs, ws, bs, C, ty, tx, acc);
#pragma unroll
    for (int i = 0; i < TW_RM; ++i) {
      const long long r = r0 + ty * TW_RM + i;
      const bool row_ok = r < R;
      const float row_lse = row_ok ? lse[r] : 0.0f;
      const float row_g = row_ok ? g[r] : 0.0f;
      const int t_row = row_ok ? tgt[r] : -1;
#pragma unroll
      for (int j = 0; j < TW_CN; ++j) {
        const int col = v0 + tx + 16 * j;
        float d = 0.0f;
        if (col < V && row_ok) {
          const float p = expf(acc[i][j] - row_lse);
          d = round_to<T>(((col == t_row ? 1.0f : 0.0f) - p) * row_g);
        }
        ds[(ty * TW_RM + i) * (TW_TV + 1) + tx + 16 * j] = d;
      }
    }
    __syncthreads();
    // this chunk's dW[c, v] = sum_r h[r, c] * dlog[r, v], db[v] = sum_r dlog[r, v]
    float part_dw[CJ][TW_CN], part_db[TW_CN];
#pragma unroll
    for (int j = 0; j < TW_CN; ++j) {
      part_db[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < CJ; ++i) part_dw[i][j] = 0.0f;
    }
    for (int r = 0; r < TW_TR; ++r) {
      float hv[CJ], dv[TW_CN];
#pragma unroll
      for (int i = 0; i < CJ; ++i) {
        const int c = ty + 16 * i;
        hv[i] = (c < C) ? hs[c * (TW_TR + 1) + r] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < TW_CN; ++j) dv[j] = ds[r * (TW_TV + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < CJ; ++i)
#pragma unroll
        for (int j = 0; j < TW_CN; ++j) part_dw[i][j] = fmaf(hv[i], dv[j], part_dw[i][j]);
      if (ty == 0) {
#pragma unroll
        for (int j = 0; j < TW_CN; ++j) part_db[j] += dv[j];
      }
    }
#pragma unroll
    for (int j = 0; j < TW_CN; ++j) {
      kahan_add(acc_db[j], comp_db[j], part_db[j]);
#pragma unroll
      for (int i = 0; i < CJ; ++i) kahan_add(acc_dw[i][j], comp_dw[i][j], part_dw[i][j]);
    }
  }

#pragma unroll
  for (int j = 0; j < TW_CN; ++j) {
    const int col = v0 + tx + 16 * j;
    if (col >= V) continue;
#pragma unroll
    for (int i = 0; i < CJ; ++i) {
      const int c = ty + 16 * i;
      if (c < C) dW[(long long)c * V + col] = acc_dw[i][j];
    }
    if (ty == 0) db[col] = acc_db[j];
  }
}

// ---------------------------------------------------------------------------
// C entry points. dtype: 0 = float32, 1 = bfloat16 (h, W and dh). Each
// returns a cudaError_t as int: 0 on success, the launch error otherwise.
// ---------------------------------------------------------------------------

namespace {

size_t fwd_smem(int C) { return sizeof(float) * (C * (TH_TR + 1) + C * (TH_TV + 1) + TH_TV); }
size_t dh_smem(int C) { return fwd_smem(C) + sizeof(float) * TH_TR * (TH_TV + 1); }
size_t dw_smem(int C) {
  return sizeof(float) * (C * (TW_TV + 1) + TW_TV + C * (TW_TR + 1) + TW_TR * (TW_TV + 1));
}

bool bad_shape(int R, int C, int V, int dtype) {
  return R < 0 || C < 1 || C > TH_MAX_C || V < 1 || (dtype != 0 && dtype != 1);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_fwd(const void* h, const void* W, const float* b, const int* tgt, float* lp,
               float* lse, int R, int C, int V, cudaStream_t stream) {
  const size_t smem = fwd_smem(C);
  cudaError_t err = allow_smem(texthead_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((R + TH_TR - 1) / TH_TR);
  texthead_fwd_kernel<T><<<blocks, TH_THREADS, smem, stream>>>(
      (const T*)h, (const T*)W, b, tgt, lp, lse, R, C, V);
  return (int)cudaGetLastError();
}

template <typename T, int CJ>
int launch_dh(const void* h, const void* W, const float* b, const int* tgt, const float* lse,
              const float* g, void* dh, int R, int C, int V, cudaStream_t stream) {
  const size_t smem = dh_smem(C);
  cudaError_t err = allow_smem(texthead_bwd_dh_kernel<T, CJ>, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((R + TH_TR - 1) / TH_TR);
  texthead_bwd_dh_kernel<T, CJ><<<blocks, TH_THREADS, smem, stream>>>(
      (const T*)h, (const T*)W, b, tgt, lse, g, (T*)dh, R, C, V);
  return (int)cudaGetLastError();
}

template <typename T, int CJ>
int launch_dw(const void* h, const void* W, const float* b, const int* tgt, const float* lse,
              const float* g, float* dW, float* db, int R, int C, int V, cudaStream_t stream) {
  const size_t smem = dw_smem(C);
  cudaError_t err = allow_smem(texthead_bwd_dw_kernel<T, CJ>, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((V + TW_TV - 1) / TW_TV);
  texthead_bwd_dw_kernel<T, CJ><<<blocks, TH_THREADS, smem, stream>>>(
      (const T*)h, (const T*)W, b, tgt, lse, g, dW, db, R, C, V);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int texthead_fwd(const void* h, const void* W, const float* b, const int* tgt,
                            float* lp, float* lse, int R, int C, int V, int dtype,
                            cudaStream_t stream) {
  if (bad_shape(R, C, V, dtype)) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  return dtype == 0 ? launch_fwd<float>(h, W, b, tgt, lp, lse, R, C, V, stream)
                    : launch_fwd<__nv_bfloat16>(h, W, b, tgt, lp, lse, R, C, V, stream);
}

extern "C" int texthead_bwd_dh(const void* h, const void* W, const float* b, const int* tgt,
                               const float* lse, const float* g, void* dh, int R, int C, int V,
                               int dtype, cudaStream_t stream) {
  if (bad_shape(R, C, V, dtype)) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  if (C <= 64) {  // 4 channels per thread (C <= 64), else 8 (C <= 128)
    return dtype == 0 ? launch_dh<float, 4>(h, W, b, tgt, lse, g, dh, R, C, V, stream)
                      : launch_dh<__nv_bfloat16, 4>(h, W, b, tgt, lse, g, dh, R, C, V, stream);
  }
  return dtype == 0 ? launch_dh<float, 8>(h, W, b, tgt, lse, g, dh, R, C, V, stream)
                    : launch_dh<__nv_bfloat16, 8>(h, W, b, tgt, lse, g, dh, R, C, V, stream);
}

extern "C" int texthead_bwd_dw(const void* h, const void* W, const float* b, const int* tgt,
                               const float* lse, const float* g, float* dW, float* db, int R,
                               int C, int V, int dtype, cudaStream_t stream) {
  if (bad_shape(R, C, V, dtype)) return (int)cudaErrorInvalidValue;
  if (C <= 64) {  // 4 channels per thread (C <= 64), else 8 (C <= 128)
    return dtype == 0 ? launch_dw<float, 4>(h, W, b, tgt, lse, g, dW, db, R, C, V, stream)
                      : launch_dw<__nv_bfloat16, 4>(h, W, b, tgt, lse, g, dW, db, R, C, V, stream);
  }
  return dtype == 0 ? launch_dw<float, 8>(h, W, b, tgt, lse, g, dW, db, R, C, V, stream)
                    : launch_dw<__nv_bfloat16, 8>(h, W, b, tgt, lse, g, dW, db, R, C, V, stream);
}
