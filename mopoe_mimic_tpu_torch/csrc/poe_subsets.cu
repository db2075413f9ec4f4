// Subset product-of-experts, forward and backward, for NVIDIA Hopper (sm_90a).
//
// The forward replaces the Pallas TPU kernel `_fusion_kernel` launched by
// `_poe_subsets_pallas_raw` (mopoe_mimic_tpu/ops/pallas_fusion.py:42, :98).
// The backward replaces the XLA VJP of the einsum form that
// `poe_subsets_pallas` uses as its gradient (pallas_fusion.py:86-92); it
// is described above `poe_subsets_bwd_f32_kernel` below.
// For stacked unimodal posteriors mus, lvs of shape [M, B, D] (f32,
// contiguous) it writes, for every one of the S modality subsets,
//
//   T_m  = 1 / (exp(lv_m) + 1e-8)                  (once per expert)
//   T_S  = prior_t + sum_{m in S} T_m              (prior first, then m ascending)
//   mu_S = (sum_{m in S} mu_m * T_m) * (1 / T_S)
//   lv_S = log(1 / T_S)
//
// into mu_out, lv_out of shape [S, B, D]. The order of operations is the
// JAX function's (ops/fusion.py poe_subsets) so that f32 results agree to
// rounding of exp and log; IEEE division, no fast-math.
//
// What bounds it: bytes. Per element it reads 2*M floats and writes 2*S
// (M = 3, S = 7: 24 B in, 56 B out) with ~30 flops, far below the card's
// flop/byte balance; at serving shapes (B <= 256, D = 64) the call is a
// few microseconds and launch latency dominates. The design answers both:
// one thread owns one (b, d) element, loads its M experts once into
// registers (unrolled, M <= 8), and emits all S outputs from them, so the
// whole all-subsets fusion is one launch with coalesced loads and stores
// instead of the ~10 elementwise launches of the plain version. The
// subset member bitmasks travel by value as a kernel parameter: no device
// allocation or copy per call.

#include <cuda_runtime.h>

#define POE_MAX_EXPERTS 8
#define POE_MAX_SUBSETS 255
#define POE_THREADS 256

struct SubsetMasks {
  int n_subsets;
  // bit m of members[s] is set when expert m belongs to subset s
  unsigned char members[POE_MAX_SUBSETS];
};

__global__ void __launch_bounds__(POE_THREADS)
poe_subsets_f32_kernel(const float* __restrict__ mus, const float* __restrict__ lvs,
                       float* __restrict__ mu_out, float* __restrict__ lv_out,
                       int n_experts, long long n, const SubsetMasks masks,
                       float prior_t) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged tail: any B works

  float t[POE_MAX_EXPERTS];
  float mu_t[POE_MAX_EXPERTS];
#pragma unroll
  for (int m = 0; m < POE_MAX_EXPERTS; ++m) {
    t[m] = 0.0f;
    mu_t[m] = 0.0f;
    if (m < n_experts) {
      const float var = expf(lvs[m * n + i]) + 1e-8f;
      t[m] = 1.0f / var;
      mu_t[m] = mus[m * n + i] * t[m];
    }
  }

  for (int s = 0; s < masks.n_subsets; ++s) {
    const unsigned bits = masks.members[s];
    float t_sum = prior_t;
    float mu_t_sum = 0.0f;
#pragma unroll
    for (int m = 0; m < POE_MAX_EXPERTS; ++m) {
      if (bits & (1u << m)) {
        t_sum += t[m];
        mu_t_sum += mu_t[m];
      }
    }
    const float pd_var = 1.0f / t_sum;
    mu_out[s * n + i] = mu_t_sum * pd_var;
    lv_out[s * n + i] = logf(pd_var);
  }
}

// Returns a cudaError_t as int: 0 on success, the launch error otherwise.
extern "C" int poe_subsets_f32(const float* mus, const float* lvs, float* mu_out,
                               float* lv_out, int n_experts, int batch, int dim,
                               SubsetMasks masks, float prior_t,
                               cudaStream_t stream) {
  if (n_experts < 1 || n_experts > POE_MAX_EXPERTS || masks.n_subsets < 1 ||
      masks.n_subsets > POE_MAX_SUBSETS || batch < 0 || dim < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)batch * dim;
  if (n == 0) return 0;
  const long long blocks = (n + POE_THREADS - 1) / POE_THREADS;
  poe_subsets_f32_kernel<<<(unsigned)blocks, POE_THREADS, 0, stream>>>(
      mus, lvs, mu_out, lv_out, n_experts, n, masks, prior_t);
  return (int)cudaGetLastError();
}

// Backward. For upstream gradients dmu_s, dlv_s [S, B, D] it recomputes,
// per (b, d), the experts' T_m and every subset's T_S and mu_S from the
// saved inputs, and accumulates over the subsets S that contain m
// (subsets in mask order, members ascending):
//
//   g      = dmu_S * (1 / T_S)
//   dmu_m += g * T_m
//   dT_m  += g * (mu_m - mu_S) - dlv_S * (1 / T_S)
//   dlv_m  = -dT_m * exp(lv_m) * T_m^2
//
// into dmu, dlv [M, B, D]: the closed form of ops/fusion.poe_subsets_bwd,
// in its order of operations. Bound by bytes like the forward (2*S + 2*M
// floats read, 2*M written per element); the same design answers it: one
// thread per (b, d), the M experts and their running gradients in
// registers, the S upstream gradients read once each, coalesced, and the
// member bitmasks by value. No atomics: each output has one owner thread.
__global__ void __launch_bounds__(POE_THREADS)
poe_subsets_bwd_f32_kernel(const float* __restrict__ mus, const float* __restrict__ lvs,
                           const float* __restrict__ dmu_s, const float* __restrict__ dlv_s,
                           float* __restrict__ dmu, float* __restrict__ dlv,
                           int n_experts, long long n, const SubsetMasks masks,
                           float prior_t) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float mu[POE_MAX_EXPERTS];
  float var[POE_MAX_EXPERTS];
  float t[POE_MAX_EXPERTS];
  float mu_t[POE_MAX_EXPERTS];
  float g_mu[POE_MAX_EXPERTS];
  float g_t[POE_MAX_EXPERTS];
#pragma unroll
  for (int m = 0; m < POE_MAX_EXPERTS; ++m) {
    mu[m] = var[m] = t[m] = mu_t[m] = g_mu[m] = g_t[m] = 0.0f;
    if (m < n_experts) {
      mu[m] = mus[m * n + i];
      var[m] = expf(lvs[m * n + i]);
      t[m] = 1.0f / (var[m] + 1e-8f);
      mu_t[m] = mu[m] * t[m];
    }
  }

  for (int s = 0; s < masks.n_subsets; ++s) {
    const unsigned bits = masks.members[s];
    float t_sum = prior_t;
    float mu_t_sum = 0.0f;
#pragma unroll
    for (int m = 0; m < POE_MAX_EXPERTS; ++m) {
      if (bits & (1u << m)) {
        t_sum += t[m];
        mu_t_sum += mu_t[m];
      }
    }
    const float inv = 1.0f / t_sum;
    const float mu_sub = mu_t_sum * inv;
    const float g = dmu_s[s * n + i] * inv;
    const float g_lv = dlv_s[s * n + i] * inv;
#pragma unroll
    for (int m = 0; m < POE_MAX_EXPERTS; ++m) {
      if (bits & (1u << m)) {
        g_mu[m] += g * t[m];
        g_t[m] += g * (mu[m] - mu_sub) - g_lv;
      }
    }
  }

#pragma unroll
  for (int m = 0; m < POE_MAX_EXPERTS; ++m) {
    if (m < n_experts) {
      dmu[m * n + i] = g_mu[m];
      dlv[m * n + i] = -g_t[m] * var[m] * (t[m] * t[m]);
    }
  }
}

// Returns a cudaError_t as int: 0 on success, the launch error otherwise.
extern "C" int poe_subsets_bwd_f32(const float* mus, const float* lvs, const float* dmu_s,
                                   const float* dlv_s, float* dmu, float* dlv,
                                   int n_experts, int batch, int dim,
                                   SubsetMasks masks, float prior_t,
                                   cudaStream_t stream) {
  if (n_experts < 1 || n_experts > POE_MAX_EXPERTS || masks.n_subsets < 1 ||
      masks.n_subsets > POE_MAX_SUBSETS || batch < 0 || dim < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)batch * dim;
  if (n == 0) return 0;
  const long long blocks = (n + POE_THREADS - 1) / POE_THREADS;
  poe_subsets_bwd_f32_kernel<<<(unsigned)blocks, POE_THREADS, 0, stream>>>(
      mus, lvs, dmu_s, dlv_s, dmu, dlv, n_experts, n, masks, prior_t);
  return (int)cudaGetLastError();
}
