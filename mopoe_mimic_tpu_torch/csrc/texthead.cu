// Fused word-text vocab head, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_bwd_kernel` of
// mopoe_mimic_tpu/ops/pallas_texthead.py (:72, :88), launched by
// `_core_fwd_raw` (:137, pallas_call :143) and `_core_bwd` (:170,
// pallas_call :175). For decoder features
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
// What bounds it on this card. The forward is 2*R*C*V = 14.7 GFLOP against
// ~4 MB of inputs, ~0.015 ms at the bf16 tensor-core peak, but also R*V =
// 115 M exponentials, ~0.028 ms on the SFUs of 132 SMs (16 a clock each):
// the exponentials bound it. The backward, as one function, is three
// products of that size (the logits recomputed, dlog @ W^T, h^T @ dlog):
// 3 * 2*R*C*V = 44 GFLOP, ~0.045 ms at the bf16 tensor-core peak, plus
// R*V = 115 M exponentials and their elementwise work for each of its two
// kernels (2 * R*V = 230 M exps, ~0.06 ms on the SFUs).
//
// bfloat16 (dtype 1, the training path): tensor cores, forward and
// backward. The TPU kernel rounds dlog to h's dtype before both backward
// products (pallas_texthead.py:101), so in bf16 every product is bf16 x
// bf16 with float32 sums: what mma.sync computes. Only the order of the
// sums changes. The kernels use mma.sync.m16n8k16 (bf16 in, f32
// accumulators) fed by ldmatrix, not wgmma: at C = 64 the logits product
// is four k-steps deep, the exponentials and elementwise work on each
// logits tile weigh as much as its products, and mma.sync keeps the logits
// (and dlog) in registers in a layout the next step takes (below), where
// wgmma would need them in shared memory or in its own register layout.
// The problem has the shape of FlashAttention: logits play QK^T, the
// forward's online logsumexp its online softmax, dlog dS, dh dQ, dW dK.
//
//  * texthead_fwd_tc: one block of 16 warps per 256 rows (every block
//    reads all of W from L2; 128 blocks at the flagship), each warp one
//    tile of 16 rows. The block stages its h rows
//    in shared memory once, keeps each warp's A fragments in registers, and
//    walks the vocabulary in tiles of 64 columns, half a tile at a time:
//    the warp's 16 x 32 logits (accumulators started at the bias), then,
//    for each of the lane's two rows, a running max m and sum l (an online
//    logsumexp): m' = max(m, the lane's 8 logits), l = l 2^((m - m') log2
//    e) + sum 2^(x log2 e - m' log2 e), one ex2 per logit and one per row
//    per half tile, and the target's logit where the lane holds its
//    column. At the end the four lanes of a quad, which share the rows,
//    combine theirs with shuffles. The logits never leave registers; each
//    row has one owner and there are no atomics. After each product comes
//    a chain of dependent steps (max, ex2, sums) whose latency, more than
//    the SFU's or the tensor cores' throughput, sets the pace: so one row
//    tile a warp and many warps an SM (<= 128 registers, 16 warps), where
//    dh gives a warp two row tiles to share each B fragment.
//  * texthead_bwd_dh_tc: one block of 4 warps per 128 rows (256 blocks at
//    the flagship), each warp two tiles of 16 rows (at C = 64; one tile at
//    C <= 128, for the registers), so that every B fragment read from
//    shared memory serves two products; staged and walked as in the
//    forward. Per half tile a warp computes its 16 x 32 logits per row tile,
//    forms dlog in place and packs it to bf16 pairs:
//    the m16n8 accumulator layout of two neighbouring n-tiles is the
//    m16n8k16 A layout, so dlog goes straight from registers into
//    dh += dlog @ W^T, and never to memory.
//  * texthead_bwd_dw_tc: one block of 8 warps (C <= 64; 16 for C <= 128)
//    per (64-column vocabulary tile, row split). There are only 55
//    vocabulary tiles at V = 3517, so the rows are split across blocks to
//    fill the 132 SMs, as many splits as spread the blocks evenly over the
//    SMs (12 at the flagship: 660 blocks, 5 an SM; texthead_bwd_dw_splits).
//    A block keeps its W tile in shared memory and loops over its row
//    chunks of 16 rows a warp: the logits and dlog of the chunk, dlog to a
//    bf16 tile in shared memory, then dW[c, tile] = h^T @ dlog (each warp
//    16 channels x 32 columns; h^T through ldmatrix.trans) and
//    db = ones @ dlog on the tensor cores too. Each chunk's product joins
//    the running sums by compensated (Kahan) addition. Each block writes
//    its split's partial dW and db; texthead_bwd_dw_finalize sums the
//    splits in a fixed order, again with Kahan addition. Every output has
//    one owner and there are no atomics: two runs give equal gradients.
//  * Operands stay bf16 in shared memory, rows padded by 16 bytes so that
//    the eight rows of each ldmatrix fall in distinct banks, and the tile
//    that comes next loads into the other of two buffers while the current
//    one computes, one barrier per tile. h's row chunks (dW) go by cp.async
//    where h's rows are 16-byte aligned (C % 8 == 0, as at the flagship),
//    else through registers. W's tiles (forward, dh) go through registers:
//    at V = 3517 (odd) the rows of W are only 2-byte aligned, below
//    cp.async's 4 bytes and TMA's 16-byte strides. A warp's rows all share
//    one alignment, so it reads 4-byte words and, where they are off by one
//    element, realigns neighbouring words with a shuffle when it stores
//    them, after the tile's products. W itself must start 4-byte aligned.
//  * Ragged edges are masked in the kernels: rows past R (not written in
//    the forward; g = 0 and a vanishing exponential in the backward),
//    columns past V (-inf logits in the forward, dlog = 0 in the backward,
//    in the last tile only), and C <= 128 zero-padded to a multiple of 16
//    in shared memory. No bias padding, no padded copies.
//  * exponentials as exp2(x * log2(e) - c) on the SFU (ex2.approx, 2 ulp):
//    their error is far below the forward's tolerance (1e-5 of lse) and the
//    bf16 rounding of dlog.
//
// float32 (dtype 0) runs on the CUDA cores in float32, forward and
// backward: tensor cores on float32 operands mean TF32 (about 3 digits),
// below float32's tolerance. What that design does:
//
//  * texthead_fwd_kernel: one block per tile of 128 rows. The h tile is
//    staged once in shared memory (C <= 128 is small); the block walks the
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
//    - texthead_bwd_dh_kernel: one block per tile of 128 rows; for each
//      vocabulary tile it recomputes the logits, forms dlog in shared
//      memory and accumulates dh = dlog @ W^T in registers;
//    - texthead_bwd_dw_kernel: one block per tile of 32 vocabulary columns
//      (110 blocks at V = 3517 for the 132 SMs); it loops over all rows in
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
#include <stdint.h>

#include "launch.cuh"

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

// h rows [r0, r0 + TR) → hs[k * (TR + 1) + r], zero beyond R
template <int TR>
__device__ __forceinline__ void load_h_tile(float* hs, const float* __restrict__ h, long long r0,
                                            int R, int C) {
  for (int idx = threadIdx.x; idx < TR * C; idx += TH_THREADS) {
    const int r = idx / C, k = idx - r * C;
    hs[k * (TR + 1) + r] = (r0 + r < R) ? h[(r0 + r) * C + k] : 0.0f;
  }
}

// W columns [v0, v0 + TV) → ws[k * (TV + 1) + c] and b → bs[c], zero beyond V
template <int TV>
__device__ __forceinline__ void load_w_tile(float* ws, float* bs, const float* __restrict__ W,
                                            const float* __restrict__ b, int v0, int C, int V) {
  for (int idx = threadIdx.x; idx < TV * C; idx += TH_THREADS) {
    const int k = idx / TV, c = idx - k * TV;
    ws[k * (TV + 1) + c] = (v0 + c < V) ? W[(long long)k * V + v0 + c] : 0.0f;
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
// forward in float32 (CUDA cores)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(TH_THREADS)
texthead_fwd_kernel(const float* __restrict__ h, const float* __restrict__ W,
                    const float* __restrict__ b, const int* __restrict__ tgt,
                    float* __restrict__ lp, float* __restrict__ lse, int R, int C, int V) {
  extern __shared__ float smem[];
  float* hs = smem;                         // [C][TH_TR + 1]
  float* ws = hs + C * (TH_TR + 1);         // [C][TH_TV + 1]
  float* bs = ws + C * (TH_TV + 1);         // [TH_TV]
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long r0 = (long long)blockIdx.x * TH_TR;

  load_h_tile<TH_TR>(hs, h, r0, R, C);

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
    load_w_tile<TH_TV>(ws, bs, W, b, v0, C, V);
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
// backward in float32 (CUDA cores): dh
// ---------------------------------------------------------------------------

template <int CJ>
__global__ void __launch_bounds__(TH_THREADS)
texthead_bwd_dh_kernel(const float* __restrict__ h, const float* __restrict__ W,
                       const float* __restrict__ b, const int* __restrict__ tgt,
                       const float* __restrict__ lse, const float* __restrict__ g,
                       float* __restrict__ dh, int R, int C, int V) {
  extern __shared__ float smem[];
  float* hs = smem;                         // [C][TH_TR + 1]
  float* ws = hs + C * (TH_TR + 1);         // [C][TH_TV + 1]
  float* bs = ws + C * (TH_TV + 1);         // [TH_TV]
  float* ds = bs + TH_TV;                   // [TH_TR][TH_TV + 1] dlog tile
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long r0 = (long long)blockIdx.x * TH_TR;

  load_h_tile<TH_TR>(hs, h, r0, R, C);

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
    load_w_tile<TH_TV>(ws, bs, W, b, v0, C, V);
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
          d = ((col == t_row[i] ? 1.0f : 0.0f) - p) * row_g[i];
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
      if (c < C) dh[r * C + c] = acc_dh[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// backward in float32 (CUDA cores): dW, db
// ---------------------------------------------------------------------------

template <int CJ>
__global__ void __launch_bounds__(TH_THREADS)
texthead_bwd_dw_kernel(const float* __restrict__ h, const float* __restrict__ W,
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

  load_w_tile<TW_TV>(ws, bs, W, b, v0, C, V);

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
    load_h_tile<TW_TR>(hs, h, r0, R, C);
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
          d = ((col == t_row ? 1.0f : 0.0f) - p) * row_g;
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
// backward in bfloat16 on tensor cores (mma.sync.m16n8k16, ldmatrix)
// ---------------------------------------------------------------------------
//
// Fragment layouts of mma.m16n8k16 for lane l, q = l / 4, s = l % 4: the
// accumulator holds rows q (regs 0, 1) and q + 8 (regs 2, 3), columns
// 2s, 2s + 1; A holds rows q, q + 8 at k = 2s, 2s + 1 (regs 0, 1) and
// k = 8 + 2s, 9 + 2s (regs 2, 3); B holds column q at k = 2s, 2s + 1 (reg 0)
// and 8 + 2s, 9 + 2s (reg 1). Each 32-bit register holds two bf16, the lower
// index in the low half.

#define TC_BN 64             // vocabulary tile
#define TC_LDW (TC_BN + 8)   // shared row stride of W and dlog tiles (bf16)
#define TC_DH_THREADS 128
#define TC_LOG2E 1.4426950408889634f
#define TC_LN2 0.6931471805599453f
#define TC_ONES 0x3F803F80u  // two bf16 1.0

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a @ b, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16 (nearest even, as a dtype cast) in one register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One 2-byte element of a row-major bf16 matrix, 0 outside it
__device__ __forceinline__ uint32_t ld_u16(const bf16* __restrict__ p, long long i, bool ok) {
  return ok ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p) + i) : 0u;
}

// Elements i and i + 1 of a bf16 array as one register; i even (4-byte
// aligned)
__device__ __forceinline__ uint32_t ld_pair(const bf16* __restrict__ p, long long i) {
  return __ldg(reinterpret_cast<const unsigned int*>(p + i));
}

// W[:, v0 : v0 + TC_BN] (rows k < C, zero to CP) and b[v0 : v0 + TC_BN] as
// bf16 pairs in registers: pair p = threadIdx.x + i * NT is row p / 32,
// columns 2 (p % 32) and the next. A thread's rows k0 + i NT / 32 all start
// at the same parity of k0 V, so the whole warp reads 4-byte words: as they
// are where k0 V is even; else the words one element earlier (and lane 31
// the element after its word), each lane taking the second half of its word
// and the first of its neighbour's when it stores them, not when it loads
// them, so that the loads stay in flight during the products: nothing reads
// a loaded register before store(). The ragged last tile reads 2-byte
// elements.
template <int CP, int NT>
struct WTile {
  static constexpr int N = CP * TC_BN / 2 / NT, DK = NT / (TC_BN / 2);
  uint32_t w[N];
  uint32_t x[N];  // lane 31's element after each word, in the low 16 bits
  float b;
  bool odd;

  __device__ __forceinline__ void fetch(const bf16* __restrict__ W, const float* __restrict__ bias,
                                        int v0, int C, int V) {
    const int k0 = threadIdx.x / (TC_BN / 2), v = v0 + 2 * (threadIdx.x % (TC_BN / 2));
    const long long at0 = (long long)k0 * V + v;
    odd = false;
    if (v0 + TC_BN <= V) {
      odd = at0 & 1;  // the same for the warp: k0 is the warp's
      const bool extra = odd && (threadIdx.x & 31) == 31;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const long long at = at0 + (long long)i * DK * V;
        const bool row = k0 + i * DK < C;
        w[i] = row ? ld_pair(W, at - odd) : 0u;
        x[i] = ld_u16(W, at + 1, row && extra);
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const long long at = at0 + (long long)i * DK * V;
        const bool row = k0 + i * DK < C;
        w[i] = ld_u16(W, at, row && v < V) | (ld_u16(W, at + 1, row && v + 1 < V) << 16);
        x[i] = 0u;
      }
    }
    const int c = v0 + (int)threadIdx.x;
    b = (threadIdx.x < TC_BN && c < V) ? bias[c] : 0.0f;
  }

  // → ws[k * TC_LDW + v], bs[v]
  __device__ __forceinline__ void store(bf16* ws, float* bs) const {
    const bool last_lane = (threadIdx.x & 31) == 31;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int p = threadIdx.x + i * NT;
      const uint32_t next = __shfl_down_sync(TH_FULL_MASK, w[i], 1);
      const uint32_t pair = !odd ? w[i] : __byte_perm(w[i], last_lane ? x[i] : next, 0x5432);
      *reinterpret_cast<uint32_t*>(ws + (p / (TC_BN / 2)) * TC_LDW + 2 * (p % (TC_BN / 2))) = pair;
    }
    if (threadIdx.x < TC_BN) bs[threadIdx.x] = b;
  }
};

// h[r0 : r0 + ROWS, :] zero-padded to CP columns (and past R) as bf16 pairs
// in registers: pair p is row p / (CP / 2), columns 2 (p % (CP / 2)) and the
// next.
template <int CP, int ROWS, int NT>
struct HTile {
  static constexpr int N = ROWS * CP / 2 / NT;
  uint32_t w[N];

  __device__ __forceinline__ void fetch(const bf16* __restrict__ h, long long r0, int R, int C) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int p = threadIdx.x + i * NT, r = p / (CP / 2), c = 2 * (p % (CP / 2));
      const bool row = r0 + r < R;
      const long long at = (r0 + r) * C + c;
      w[i] = ld_u16(h, at, row && c < C) | (ld_u16(h, at + 1, row && c + 1 < C) << 16);
    }
  }

  // → hs[r * LDH + c]
  __device__ __forceinline__ void store(bf16* hs, int ldh) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int p = threadIdx.x + i * NT;
      *reinterpret_cast<uint32_t*>(hs + (p / (CP / 2)) * ldh + 2 * (p % (CP / 2))) = w[i];
    }
  }
};

// h[r0 : r0 + ROWS, :] zero-padded to CP columns (and past R) → hs[r * ldh
// + c] by cp.async, 16 bytes a copy, with no registers: C % 8 == 0 and h
// 16-byte aligned. One commit group; wait with cp_async_wait_all.
template <int CP, int ROWS, int NT>
__device__ __forceinline__ void copy_rows_async(bf16* hs, int ldh, const bf16* __restrict__ h,
                                                long long r0, int R, int C) {
  constexpr int CH = CP / 8;  // 16-byte pieces of a row
#pragma unroll
  for (int i = 0; i < ROWS * CH / NT; ++i) {
    const int p = threadIdx.x + i * NT, r = p / CH, c = 8 * (p % CH);
    const bool ok = r0 + r < R && c < C;
    const bf16* src = ok ? h + (r0 + r) * C + c : h;  // 0 bytes read where !ok: zero-filled
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_addr(hs + r * ldh + c)), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A fragments of the 16 rows at hs (row stride ldh), all KT k-steps of C
template <int KT>
__device__ __forceinline__ void load_rows_a(uint32_t (&ha)[KT][4], const bf16* hs, int ldh,
                                            int lane) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    ldsm_x4(ha[kt], hs + (lane & 15) * ldh + kt * 16 + (lane >> 4) * 8);
  }
}

// The logits h @ W + b of RT tiles of 16 rows (A fragments ha) and the W
// tile's columns 32 hf .. + 31: acc[rt][n] is the accumulator of columns
// 32 hf + 8n .. + 7. Half a tile at a time keeps the live registers down;
// each B fragment (k = channel, n = column; from the row-major W tile
// through ldmatrix.trans) serves all RT row tiles.
template <int KT, int RT>
__device__ __forceinline__ void warp_logits(const uint32_t (&ha)[RT][KT][4], const bf16* ws,
                                            const float* bs, int hf, int lane,
                                            float (&acc)[RT][4][4]) {
  const int s = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float b0 = bs[32 * hf + 8 * n + 2 * s], b1 = bs[32 * hf + 8 * n + 2 * s + 1];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      acc[rt][n][0] = acc[rt][n][2] = b0;
      acc[rt][n][1] = acc[rt][n][3] = b1;
    }
  }
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, ws + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_LDW + 32 * hf +
                       np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        mma_bf16(acc[rt][2 * np], ha[rt][kt], b[0], b[1]);
        mma_bf16(acc[rt][2 * np + 1], ha[rt][kt], b[2], b[3]);
      }
    }
  }
}

// The lane's two rows (q and q + 8 of its warp's 16): -lse * log2(e), g and
// the target; rows past R get -inf, 0 and -1, so that their dlog is 0.
struct RowData {
  float nl[2], g[2];
  int t[2];

  __device__ __forceinline__ void fetch(const int* __restrict__ tgt, const float* __restrict__ lse,
                                        const float* __restrict__ gr, long long row, int R) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long r = row + 8 * i;
      const bool ok = r < R;
      nl[i] = ok ? -lse[r] * TC_LOG2E : -INFINITY;
      g[i] = ok ? gr[r] : 0.0f;
      t[i] = ok ? tgt[r] : -1;
    }
  }
};

// logits → dlog = (onehot(t) - exp(logits - lse)) * g in place, for the
// columns col0 + 8n (+1) of acc[n]; RAGGED zeroes the columns past V.
template <bool RAGGED>
__device__ __forceinline__ void form_dlog(float (&acc)[4][4], const RowData& rd, int col0, int V) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * n + e;
        const float p = ex2(fmaf(acc[n][2 * i + e], TC_LOG2E, rd.nl[i]));
        float d = ((col == rd.t[i] ? 1.0f : 0.0f) - p) * rd.g[i];
        if (RAGGED && col >= V) d = 0.0f;
        acc[n][2 * i + e] = d;
      }
}

// The forward's online logsumexp of the lane's two rows (q and q + 8 of
// its warp's 16) over the columns the lane sees, in base 2: the running max
// c of x log2 e, the sum l of 2^(x log2 e - c), and the target's logit where
// the lane holds its column (0 elsewhere). Rows past R get the target -1
// (never seen). c is the offset the terms were taken against, so a rescale
// by 2^(c - c') is exact where c' = c (no drift over the tiles).
struct RowLse {
  float c[2], l[2], tl[2];
  int t[2];

  __device__ __forceinline__ void init(const int* __restrict__ tgt, long long row, int R) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      c[i] = -INFINITY;
      l[i] = 0.0f;
      tl[i] = 0.0f;
      t[i] = row + 8 * i < R ? tgt[row + 8 * i] : -1;
    }
  }

  // Fold in the logits of acc (columns col0 + 8n (+1), as warp_logits
  // leaves them): one ex2 per logit and one per row. RAGGED masks the
  // columns past V to -inf; a lane that has seen no column yet keeps
  // c = -inf and l = 0, and takes its terms against 0, never -inf.
  template <bool RAGGED>
  __device__ __forceinline__ void update(float (&acc)[4][4], int col0, int V) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mn[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (RAGGED && col0 + 8 * n + e >= V) acc[n][2 * i + e] = -INFINITY;
        mn[n] = fmaxf(acc[n][2 * i], acc[n][2 * i + 1]);
      }
      const float mx = fmaxf(fmaxf(mn[0], mn[1]), fmaxf(mn[2], mn[3]));  // a tree: short chains
      const float cn = fmaxf(c[i], mx * TC_LOG2E);
      const float off = cn == -INFINITY ? 0.0f : cn;
      float part[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        part[n] = ex2(fmaf(acc[n][2 * i], TC_LOG2E, -off)) +
                  ex2(fmaf(acc[n][2 * i + 1], TC_LOG2E, -off));
      }
      l[i] = fmaf(l[i], ex2(c[i] - off), (part[0] + part[1]) + (part[2] + part[3]));
      c[i] = cn;
      const unsigned rel = (unsigned)(t[i] - col0);  // the target is column col0 + 8n + e
      if (rel < 32u && (rel & 6u) == 0u) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (rel == (unsigned)(8 * n + e)) tl[i] = acc[n][2 * i + e];
      }
    }
  }

  // Row i's lse and lp from the four lanes of the quad, which share the row
  // (every lane calls it; the shuffles need the whole warp). A lane that saw
  // no column (c = -inf, l = 0) adds 0.
  __device__ __forceinline__ void finish(int i, float& out_lse, float& out_lp) const {
    float cq = fmaxf(c[i], __shfl_xor_sync(TH_FULL_MASK, c[i], 1));
    cq = fmaxf(cq, __shfl_xor_sync(TH_FULL_MASK, cq, 2));
    const float off = cq == -INFINITY ? 0.0f : cq;
    float lq = l[i] * ex2(c[i] - off);
    lq += __shfl_xor_sync(TH_FULL_MASK, lq, 1);
    lq += __shfl_xor_sync(TH_FULL_MASK, lq, 2);
    float tq = tl[i] + __shfl_xor_sync(TH_FULL_MASK, tl[i], 1);
    tq += __shfl_xor_sync(TH_FULL_MASK, tq, 2);
    out_lse = fmaf(off, TC_LN2, logf(lq));  // ln(sum e^x) = c ln 2 + ln(l)
    out_lp = tq - out_lse;
  }
};

// lp and lse for NW warps of 16 rows a block, C <= 16 * KT.
template <int KT, int NW>
__global__ void __launch_bounds__(32 * NW)
texthead_fwd_tc(const bf16* __restrict__ h, const bf16* __restrict__ W,
                const float* __restrict__ b, const int* __restrict__ tgt,
                float* __restrict__ lp, float* __restrict__ lse, int R, int C, int V) {
  constexpr int CP = 16 * KT, LDH = CP + 8, NT = 32 * NW, BM = 16 * NW;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* hs = reinterpret_cast<bf16*>(tc_smem);                 // [BM][LDH]
  bf16* ws = hs + BM * LDH;                                    // [2][CP][TC_LDW]
  float* bs = reinterpret_cast<float*>(ws + 2 * CP * TC_LDW);  // [2][TC_BN]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, s = lane & 3;
  const long long r0 = (long long)blockIdx.x * BM;
  const int tiles = (V + TC_BN - 1) / TC_BN;

  {
    HTile<CP, BM, NT> ht;
    ht.fetch(h, r0, R, C);
    ht.store(hs, LDH);
  }
  WTile<CP, NT> next;
  next.fetch(W, b, 0, C, V);
  next.store(ws, bs);
  __syncthreads();

  // the warp's rows r0 + 16 warp .. + 15
  uint32_t ha[1][KT][4];
  RowLse st;
  load_rows_a<KT>(ha[0], hs + 16 * warp * LDH, LDH, lane);
  st.init(tgt, r0 + 16 * warp + (lane >> 2), R);

  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1, v0 = j * TC_BN;
    const bool more = j + 1 < tiles;
    if (more) next.fetch(W, b, v0 + TC_BN, C, V);  // in flight during this tile's products
    const bf16* wt = ws + buf * CP * TC_LDW;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float acc[1][4][4];
      warp_logits<KT, 1>(ha, wt, bs + buf * TC_BN, hf, lane, acc);
      if (v0 + TC_BN <= V) {
        st.update<false>(acc[0], v0 + 32 * hf + 2 * s, V);
      } else {
        st.update<true>(acc[0], v0 + 32 * hf + 2 * s, V);
      }
    }
    if (more) next.store(ws + (buf ^ 1) * CP * TC_LDW, bs + (buf ^ 1) * TC_BN);
    __syncthreads();  // the next tile is in place, this one's readers are done
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float row_lse, row_lp;
    st.finish(i, row_lse, row_lp);
    const long long r = r0 + 16 * warp + (lane >> 2) + 8 * i;
    if (s == 0 && r < R) {
      lse[r] = row_lse;
      lp[r] = row_lp;
    }
  }
}

// dh = dlog @ W^T for 4 warps of 16 RT rows a block, C <= 16 * KT.
template <int KT, int RT>
__global__ void __launch_bounds__(TC_DH_THREADS, KT == 4 ? 2 : 1)
texthead_bwd_dh_tc(const bf16* __restrict__ h, const bf16* __restrict__ W,
                   const float* __restrict__ b, const int* __restrict__ tgt,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   bf16* __restrict__ dh, int R, int C, int V) {
  constexpr int CP = 16 * KT, LDH = CP + 8, BM = 64 * RT;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* hs = reinterpret_cast<bf16*>(tc_smem);            // [BM][LDH]
  bf16* ws = hs + BM * LDH;                               // [2][CP][TC_LDW]
  float* bs = reinterpret_cast<float*>(ws + 2 * CP * TC_LDW);  // [2][TC_BN]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, s = lane & 3;
  const long long r0 = (long long)blockIdx.x * BM;
  const int tiles = (V + TC_BN - 1) / TC_BN;

  {
    HTile<CP, BM, TC_DH_THREADS> ht;
    ht.fetch(h, r0, R, C);
    ht.store(hs, LDH);
  }
  WTile<CP, TC_DH_THREADS> next;
  next.fetch(W, b, 0, C, V);
  next.store(ws, bs);
  __syncthreads();

  // the warp's row tiles rt: rows r0 + 16 (RT warp + rt) .. + 15
  uint32_t ha[RT][KT][4];
  RowData rd[RT];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    load_rows_a<KT>(ha[rt], hs + 16 * (RT * warp + rt) * LDH, LDH, lane);
    rd[rt].fetch(tgt, lse, g, r0 + 16 * (RT * warp + rt) + (lane >> 2), R);
  }

  float acc_dh[RT][2 * KT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc_dh[rt][n][k] = 0.0f;

  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1, v0 = j * TC_BN;
    const bool more = j + 1 < tiles;
    if (more) next.fetch(W, b, v0 + TC_BN, C, V);  // in flight during this tile's products
    const bf16* wt = ws + buf * CP * TC_LDW;

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float acc[RT][4][4];
      warp_logits<KT, RT>(ha, wt, bs + buf * TC_BN, hf, lane, acc);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        if (v0 + TC_BN <= V) {
          form_dlog<false>(acc[rt], rd[rt], v0 + 32 * hf + 2 * s, V);
        } else {
          form_dlog<true>(acc[rt], rd[rt], v0 + 32 * hf + 2 * s, V);
        }
      }
      // dh += dlog @ W^T: dlog's accumulators of columns 16 ks .. + 15 are
      // the A fragment of k-step ks; B (k = column, n = channel) from the
      // same W tile through ldmatrix without .trans
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        uint32_t a[RT][4];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          a[rt][0] = pack_bf16(acc[rt][2 * kh][0], acc[rt][2 * kh][1]);
          a[rt][1] = pack_bf16(acc[rt][2 * kh][2], acc[rt][2 * kh][3]);
          a[rt][2] = pack_bf16(acc[rt][2 * kh + 1][0], acc[rt][2 * kh + 1][1]);
          a[rt][3] = pack_bf16(acc[rt][2 * kh + 1][2], acc[rt][2 * kh + 1][3]);
        }
        const int ks = 2 * hf + kh;
#pragma unroll
        for (int cp = 0; cp < KT; ++cp) {
          uint32_t bw[4];
          ldsm_x4(bw, wt + (cp * 16 + (lane & 7) + (lane >> 4) * 8) * TC_LDW + ks * 16 +
                          ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) {
            mma_bf16(acc_dh[rt][2 * cp], a[rt], bw[0], bw[1]);
            mma_bf16(acc_dh[rt][2 * cp + 1], a[rt], bw[2], bw[3]);
          }
        }
      }
    }
    if (more) next.store(ws + (buf ^ 1) * CP * TC_LDW, bs + (buf ^ 1) * TC_BN);
    __syncthreads();  // the next tile is in place, this one's readers are done
  }

#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long r = r0 + 16 * (RT * warp + rt) + (lane >> 2) + 8 * i;
      if (r >= R) continue;
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * s + e;
          if (c < C) dh[r * C + c] = __float2bfloat16(acc_dh[rt][n][2 * i + e]);
        }
    }
}

// Partial dW [C, V] and db [V] of row split blockIdx.y for the vocabulary
// tile blockIdx.x, C <= 16 * KT; 2 * KT warps and row chunks of 16 rows a
// warp. In the dW product warp w owns channels 16 (w % KT) .. + 15 and the
// tile's columns 32 (w / KT) .. + 31.
template <int KT, bool ASYNC>
__global__ void __launch_bounds__(64 * KT, KT == 4 ? 2 : 1)
texthead_bwd_dw_tc(const bf16* __restrict__ h, const bf16* __restrict__ W,
                   const float* __restrict__ b, const int* __restrict__ tgt,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   float* __restrict__ part_dw, float* __restrict__ part_db, int R, int C, int V) {
  constexpr int CP = 16 * KT, LDH = CP + 8, NT = 64 * KT, BK = 32 * KT;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ws = reinterpret_cast<bf16*>(tc_smem);            // [CP][TC_LDW], fixed
  bf16* hs = ws + CP * TC_LDW;                            // [2][BK][LDH]
  bf16* ds = hs + 2 * BK * LDH;                           // [BK][TC_LDW] dlog chunk
  float* bs = reinterpret_cast<float*>(ds + BK * TC_LDW);  // [TC_BN]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane >> 2, s = lane & 3;
  const int ct = warp % KT, half = warp / KT;  // the warp's channel tile and column half
  const int v0 = blockIdx.x * TC_BN, split = blockIdx.y, splits = gridDim.y;
  const int chunks = (R + BK - 1) / BK;
  const int c_begin = (int)((long long)chunks * split / splits);
  const int c_end = (int)((long long)chunks * (split + 1) / splits);
  const bool ragged = v0 + TC_BN > V;

  {
    WTile<CP, NT> wt;
    wt.fetch(W, b, v0, C, V);
    wt.store(ws, bs);
  }
  HTile<CP, BK, NT> next;
  RowData rd, next_rd;
  if (c_begin < c_end) {
    if (ASYNC) {
      copy_rows_async<CP, BK, NT>(hs, LDH, h, (long long)c_begin * BK, R, C);
      cp_async_wait_all();
    } else {
      next.fetch(h, (long long)c_begin * BK, R, C);
      next.store(hs, LDH);
    }
    rd.fetch(tgt, lse, g, (long long)c_begin * BK + warp * 16 + q, R);
  }
  __syncthreads();

  // running sums: dW of channels 16 ct + q (regs 0, 1) and + 8 (2, 3),
  // columns 32 half + 8 j + 2s (+1); db of columns 32 half + 8 ct + 2s (+1)
  // (warps with ct < 4)
  float run[4][4], comp[4][4], run_db[2] = {0.0f, 0.0f}, comp_db[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) run[j][k] = comp[j][k] = 0.0f;
  const uint32_t ones[4] = {TC_ONES, TC_ONES, TC_ONES, TC_ONES};

  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    const bool more = c + 1 < c_end;
    if (more) {  // in flight during this chunk's products
      if (ASYNC) {
        copy_rows_async<CP, BK, NT>(hs + (buf ^ 1) * BK * LDH, LDH, h, (long long)(c + 1) * BK,
                                    R, C);
      } else {
        next.fetch(h, (long long)(c + 1) * BK, R, C);
      }
      next_rd.fetch(tgt, lse, g, (long long)(c + 1) * BK + warp * 16 + q, R);
    }
    const bf16* hb = hs + buf * BK * LDH;

    uint32_t ha[1][KT][4];
    load_rows_a<KT>(ha[0], hb + warp * 16 * LDH, LDH, lane);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {  // the logits and dlog of the warp's 16 rows → ds
      float acc[1][4][4];
      warp_logits<KT, 1>(ha, ws, bs, hf, lane, acc);
      if (ragged) {
        form_dlog<true>(acc[0], rd, v0 + 32 * hf + 2 * s, V);
      } else {
        form_dlog<false>(acc[0], rd, v0 + 32 * hf + 2 * s, V);
      }
      bf16* dr = ds + (warp * 16 + q) * TC_LDW + 32 * hf + 2 * s;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<uint32_t*>(dr + 8 * n) = pack_bf16(acc[0][n][0], acc[0][n][1]);
        *reinterpret_cast<uint32_t*>(dr + 8 * TC_LDW + 8 * n) =
            pack_bf16(acc[0][n][2], acc[0][n][3]);
      }
    }
    __syncthreads();  // dlog of the chunk is in place

    // this chunk's dW = h^T @ dlog for the warp's channels and columns: A
    // (m = channel, k = row) from the row-major h chunk through
    // ldmatrix.trans, B (k = row, n = column) from dlog likewise; db =
    // ones @ dlog
    float part[4][4], part_b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 4; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 2 * KT; ++ks) {
      uint32_t a[4];
      ldsm_x4_t(a, hb + (ks * 16 + (lane & 7) + (lane >> 4) * 8) * LDH + ct * 16 +
                       ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bd[4];
        ldsm_x4_t(bd, ds + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_LDW +
                          32 * half + 16 * jp + (lane >> 4) * 8);
        mma_bf16(part[2 * jp], a, bd[0], bd[1]);
        mma_bf16(part[2 * jp + 1], a, bd[2], bd[3]);
        if (ct == 2 * jp) mma_bf16(part_b, ones, bd[0], bd[1]);
        if (ct == 2 * jp + 1) mma_bf16(part_b, ones, bd[2], bd[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) kahan_add(run[j][k], comp[j][k], part[j][k]);
    kahan_add(run_db[0], comp_db[0], part_b[0]);
    kahan_add(run_db[1], comp_db[1], part_b[1]);
    if (more) {
      if (ASYNC) {
        cp_async_wait_all();
      } else {
        next.store(hs + (buf ^ 1) * BK * LDH, LDH);
      }
      rd = next_rd;
    }
    __syncthreads();  // the next chunk is in place, ds and this chunk's readers are done
  }

  float* pw = part_dw + (long long)split * C * V;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ch = 16 * ct + q + 8 * i;
    if (ch >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = v0 + 32 * half + 8 * j + 2 * s + e;
        if (col < V) pw[(long long)ch * V + col] = run[j][2 * i + e];
      }
  }
  if (ct < 4 && q == 0) {  // every row of ones @ dlog is db; lanes 0..3 write row 0
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = v0 + 32 * half + 8 * ct + 2 * s + e;
      if (col < V) part_db[(long long)split * V + col] = run_db[e];
    }
  }
}

// dW = sum of the splits' partials, db likewise, in split order with Kahan
// addition (one thread per output)
__global__ void texthead_bwd_dw_finalize_kernel(const float* __restrict__ part_dw,
                                                const float* __restrict__ part_db,
                                                float* __restrict__ dW, float* __restrict__ db,
                                                int splits, int C, int V) {
  const long long n_w = (long long)C * V, n = n_w + V;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const bool is_w = i < n_w;
    const float* p = is_w ? part_dw + i : part_db + (i - n_w);
    const long long stride = is_w ? n_w : V;
    float sum = 0.0f, comp = 0.0f;
    for (int k = 0; k < splits; ++k) kahan_add(sum, comp, p[k * stride]);
    if (is_w) {
      dW[i] = sum;
    } else {
      db[i - n_w] = sum;
    }
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

// cudaFuncSetAttribute and the occupancy query once per instantiation,
// device and size (launch.cuh's prepare), not at every launch
template <auto K>
cudaError_t allow_smem(size_t bytes, int threads) {
  int wave = 0;
  return prepare<K>(bytes, threads, &wave);
}

int launch_fwd(const void* h, const void* W, const float* b, const int* tgt, float* lp,
               float* lse, int R, int C, int V, cudaStream_t stream) {
  const size_t smem = fwd_smem(C);
  cudaError_t err = allow_smem<texthead_fwd_kernel>(smem, TH_THREADS);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((R + TH_TR - 1) / TH_TR);
  texthead_fwd_kernel<<<blocks, TH_THREADS, smem, stream>>>(
      (const float*)h, (const float*)W, b, tgt, lp, lse, R, C, V);
  return (int)cudaGetLastError();
}

template <int CJ>
int launch_dh(const void* h, const void* W, const float* b, const int* tgt, const float* lse,
              const float* g, void* dh, int R, int C, int V, cudaStream_t stream) {
  const size_t smem = dh_smem(C);
  cudaError_t err = allow_smem<texthead_bwd_dh_kernel<CJ>>(smem, TH_THREADS);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((R + TH_TR - 1) / TH_TR);
  texthead_bwd_dh_kernel<CJ><<<blocks, TH_THREADS, smem, stream>>>(
      (const float*)h, (const float*)W, b, tgt, lse, g, (float*)dh, R, C, V);
  return (int)cudaGetLastError();
}

template <int CJ>
int launch_dw(const void* h, const void* W, const float* b, const int* tgt, const float* lse,
              const float* g, float* dW, float* db, int R, int C, int V, cudaStream_t stream) {
  const size_t smem = dw_smem(C);
  cudaError_t err = allow_smem<texthead_bwd_dw_kernel<CJ>>(smem, TH_THREADS);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((V + TW_TV - 1) / TW_TV);
  texthead_bwd_dw_kernel<CJ><<<blocks, TH_THREADS, smem, stream>>>(
      (const float*)h, (const float*)W, b, tgt, lse, g, dW, db, R, C, V);
  return (int)cudaGetLastError();
}

template <int KT, int NW>
size_t fwd_tc_smem() {
  constexpr int CP = 16 * KT, BM = 16 * NW;
  return sizeof(bf16) * (BM * (CP + 8) + 2 * CP * TC_LDW) + sizeof(float) * 2 * TC_BN;
}

// Warps a block of texthead_fwd_tc, 16 rows each: every block reads all of
// W from L2, so many rows a block (R = 32768: 128 blocks for 132 SMs)
constexpr int FWD_NW = 16;

template <int KT>
int launch_fwd_tc(const void* h, const void* W, const float* b, const int* tgt, float* lp,
                  float* lse, int R, int C, int V, cudaStream_t stream) {
  constexpr int BM = 16 * FWD_NW;
  const size_t smem = fwd_tc_smem<KT, FWD_NW>();
  cudaError_t err = allow_smem<texthead_fwd_tc<KT, FWD_NW>>(smem, 32 * FWD_NW);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((R + BM - 1) / BM);
  texthead_fwd_tc<KT, FWD_NW><<<blocks, 32 * FWD_NW, smem, stream>>>(
      (const bf16*)h, (const bf16*)W, b, tgt, lp, lse, R, C, V);
  return (int)cudaGetLastError();
}

// dh: row tiles of 16 a warp (RT), 2 at C <= 64 so that each B fragment
// serves two, 1 at C <= 128 for the registers
template <int KT>
constexpr int dh_rt() { return KT == 4 ? 2 : 1; }

template <int KT>
size_t dh_tc_smem() {
  constexpr int CP = 16 * KT, BM = 64 * dh_rt<KT>();
  return sizeof(bf16) * (BM * (CP + 8) + 2 * CP * TC_LDW) + sizeof(float) * 2 * TC_BN;
}

template <int KT>
size_t dw_tc_smem() {
  constexpr int CP = 16 * KT, BK = 32 * KT;
  return sizeof(bf16) * (CP * TC_LDW + 2 * BK * (CP + 8) + BK * TC_LDW) + sizeof(float) * TC_BN;
}

template <int KT>
int launch_dh_tc(const void* h, const void* W, const float* b, const int* tgt, const float* lse,
                 const float* g, void* dh, int R, int C, int V, cudaStream_t stream) {
  constexpr int RT = dh_rt<KT>();
  const size_t smem = dh_tc_smem<KT>();
  cudaError_t err = allow_smem<texthead_bwd_dh_tc<KT, RT>>(smem, TC_DH_THREADS);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((R + 64 * RT - 1) / (64 * RT));
  texthead_bwd_dh_tc<KT, RT><<<blocks, TC_DH_THREADS, smem, stream>>>(
      (const bf16*)h, (const bf16*)W, b, tgt, lse, g, (bf16*)dh, R, C, V);
  return (int)cudaGetLastError();
}

template <int KT, bool ASYNC>
int launch_dw_tc_with(const void* h, const void* W, const float* b, const int* tgt,
                      const float* lse, const float* g, float* part_dw, float* part_db, int R,
                      int C, int V, int splits, cudaStream_t stream) {
  const size_t smem = dw_tc_smem<KT>();
  cudaError_t err = allow_smem<texthead_bwd_dw_tc<KT, ASYNC>>(smem, 64 * KT);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((V + TC_BN - 1) / TC_BN), (unsigned)splits);
  texthead_bwd_dw_tc<KT, ASYNC><<<grid, 64 * KT, smem, stream>>>(
      (const bf16*)h, (const bf16*)W, b, tgt, lse, g, part_dw, part_db, R, C, V);
  return (int)cudaGetLastError();
}

// h's row chunks by cp.async where its rows are 16-byte aligned
template <int KT>
int launch_dw_tc(const void* h, const void* W, const float* b, const int* tgt, const float* lse,
                 const float* g, float* part_dw, float* part_db, int R, int C, int V, int splits,
                 cudaStream_t stream) {
  const bool aligned = C % 8 == 0 && (uintptr_t)h % 16 == 0;
  return aligned ? launch_dw_tc_with<KT, true>(h, W, b, tgt, lse, g, part_dw, part_db, R, C,
                                               V, splits, stream)
                 : launch_dw_tc_with<KT, false>(h, W, b, tgt, lse, g, part_dw, part_db, R, C,
                                                V, splits, stream);
}

// Row splits of texthead_bwd_dw_tc: the blocks (vocabulary tiles x splits)
// should spread evenly over the SMs. Of 1..32 splits (at most one per row
// chunk), the fewest whose busiest SM's share of the work,
// ceil(blocks / SMs) / splits, is within 2% of the best.
int dw_splits(int R, int V, int row_chunk) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const long long tiles = (V + TC_BN - 1) / TC_BN, chunks = (R + row_chunk - 1) / row_chunk;
  const int most = (int)(chunks < 32 ? (chunks < 1 ? 1 : chunks) : 32);
  double share[33];
  double best = 1e30;
  for (int n = 1; n <= most; ++n) {
    share[n] = (double)((tiles * n + sms - 1) / sms) / n;
    if (share[n] < best) best = share[n];
  }
  for (int n = 1; n <= most; ++n) {
    if (share[n] <= 1.02 * best) return n;
  }
  return most;
}

}  // namespace

// dtype 1 (bf16): the tensor-core kernel; dtype 0: the float32 CUDA-core one
extern "C" int texthead_fwd(const void* h, const void* W, const float* b, const int* tgt,
                            float* lp, float* lse, int R, int C, int V, int dtype,
                            cudaStream_t stream) {
  if (bad_shape(R, C, V, dtype)) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  if (dtype == 1) {  // C zero-padded to 64 or 128; W read as 4-byte words
    if ((uintptr_t)W % 4 != 0) return (int)cudaErrorMisalignedAddress;
    return C <= 64 ? launch_fwd_tc<4>(h, W, b, tgt, lp, lse, R, C, V, stream)
                   : launch_fwd_tc<8>(h, W, b, tgt, lp, lse, R, C, V, stream);
  }
  return launch_fwd(h, W, b, tgt, lp, lse, R, C, V, stream);
}

// dtype 1 (bf16): the tensor-core kernel; dtype 0: the float32 CUDA-core one
extern "C" int texthead_bwd_dh(const void* h, const void* W, const float* b, const int* tgt,
                               const float* lse, const float* g, void* dh, int R, int C, int V,
                               int dtype, cudaStream_t stream) {
  if (bad_shape(R, C, V, dtype)) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  if (dtype == 1) {  // C zero-padded to 64 or 128; W read as 4-byte words
    if ((uintptr_t)W % 4 != 0) return (int)cudaErrorMisalignedAddress;
    return C <= 64 ? launch_dh_tc<4>(h, W, b, tgt, lse, g, dh, R, C, V, stream)
                   : launch_dh_tc<8>(h, W, b, tgt, lse, g, dh, R, C, V, stream);
  }
  // 4 channels per thread (C <= 64), else 8 (C <= 128)
  return C <= 64 ? launch_dh<4>(h, W, b, tgt, lse, g, dh, R, C, V, stream)
                 : launch_dh<8>(h, W, b, tgt, lse, g, dh, R, C, V, stream);
}

// The row splits that texthead_bwd_dw takes for bf16 at (R, C, V); < 0 is a
// cudaError_t, negated.
extern "C" int texthead_bwd_dw_splits(int R, int C, int V) {
  if (bad_shape(R, C, V, 1)) return -(int)cudaErrorInvalidValue;
  return dw_splits(R, V, C <= 64 ? 32 * 4 : 32 * 8);
}

// dtype 1 (bf16): the tensor-core kernel writes the partial sums of
// `splits` row splits, dW [splits, C, V] and db [splits, V], which
// texthead_bwd_dw_finalize adds up. dtype 0: the float32 CUDA-core kernel
// writes dW [C, V] and db [V] themselves (splits = 1).
extern "C" int texthead_bwd_dw(const void* h, const void* W, const float* b, const int* tgt,
                               const float* lse, const float* g, float* dW, float* db, int R,
                               int C, int V, int splits, int dtype, cudaStream_t stream) {
  if (bad_shape(R, C, V, dtype) || splits < 1 || (dtype == 0 && splits != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    if ((uintptr_t)W % 4 != 0) return (int)cudaErrorMisalignedAddress;
    return C <= 64 ? launch_dw_tc<4>(h, W, b, tgt, lse, g, dW, db, R, C, V, splits, stream)
                   : launch_dw_tc<8>(h, W, b, tgt, lse, g, dW, db, R, C, V, splits, stream);
  }
  return C <= 64 ? launch_dw<4>(h, W, b, tgt, lse, g, dW, db, R, C, V, stream)
                 : launch_dw<8>(h, W, b, tgt, lse, g, dW, db, R, C, V, stream);
}

extern "C" int texthead_bwd_dw_finalize(const float* part_dw, const float* part_db, float* dW,
                                        float* db, int splits, int C, int V,
                                        cudaStream_t stream) {
  if (splits < 1 || C < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)C * V + V;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  texthead_bwd_dw_finalize_kernel<<<blocks, 256, 0, stream>>>(part_dw, part_db, dW, db, splits,
                                                               C, V);
  return (int)cudaGetLastError();
}
