// Subset product-of-experts, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fusion_kernel` launched by
// `_poe_subsets_pallas_raw` (mopoe_mimic_tpu/ops/pallas_fusion.py:42, :98).
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
