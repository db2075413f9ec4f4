// Subset product-of-experts, forward and backward, for NVIDIA Hopper (sm_90a).
//
// The forward replaces the Pallas TPU kernel `_fusion_kernel` launched by
// `_poe_subsets_pallas_raw` (mopoe_mimic_tpu/ops/pallas_fusion.py:42, :128).
// The backward replaces the XLA VJP of the einsum form that
// `poe_subsets_pallas` uses as its gradient (pallas_fusion.py:83-92); it
// is described above `poe_subsets_bwd_f32_kernel` below.
// For M unimodal posteriors mu_m, lv_m, each a [B, D] float32 tensor with
// unit stride along D and its own row stride, it writes, for every one of
// the S modality subsets,
//
//   T_m  = 1 / (exp(lv_m) + 1e-8)                  (once per expert)
//   T_S  = prior_t + sum_{m in S} T_m              (prior first, then m ascending)
//   mu_S = (sum_{m in S} mu_m * T_m) * (1 / T_S)
//   lv_S = log(1 / T_S)
//
// into mu_out, lv_out of shape [S, B, D] (contiguous). The order of
// operations is the JAX function's (ops/fusion.py poe_subsets) so that f32
// results agree to rounding of exp and log; IEEE division, no fast-math,
// and mu_m * T_m rounded before it is summed (no FMA contraction), so that
// the forward is bitwise equal to the plain version on the card.
//
// What bounds it: bytes, in principle. Per element it reads 2*M floats and
// writes 2*S (M = 3, S = 7: 24 B in, 56 B out) with ~30 flops, far below
// the card's flop/byte balance. At the model's shapes (B <= 256, D = 64) a
// call moves at most 1.3 MB (0.2-0.5 us at the memory's rate) and the
// latency of the launch and of the dependent round trips to device memory
// is what a call costs. The design answers that:
//  - The experts are read where they lie: a by-value struct of M pointers
//    and row strides (`Experts`), no [M, B, D] stack built before the call.
//  - The layouts the model uses, the full power set of M <= 3 experts in
//    subset_powerset order with and without the prior expert, are
//    template instantiations (M, prior): members are compile-time bits and
//    every loop is unrolled, so a thread issues all 2M loads of the forward,
//    and all 2M + 2S loads of the backward, before any arithmetic: one
//    round trip to device memory per thread, not one per subset.
//  - A thread owns one element, in blocks of POE_THREADS = 128 threads:
//    128 blocks at B = 256, D = 64, one wave on 132 SMs. A sweep of 1, 2
//    and 4 elements a thread (8- and 16-byte accesses) by 64, 128 and 256
//    threads a block found this fastest at B = 8, 128 and 256 (PERF.md):
//    each thread's chain of exp, divide and log is the latency, and more
//    elements a thread lengthen it on fewer threads.
//  - Any other mask (up to 8 experts, any rows) takes the generic kernels,
//    which read the member bitmasks by value and loop over the subsets at
//    run time.
// No device allocation or copy per call; no atomics: each output has one
// owner thread.

#include <cuda_runtime.h>

#include <climits>

#define POE_MAX_EXPERTS 8
#define POE_MAX_SUBSETS 255
#define POE_POWERSET_MAX_EXPERTS 3
#define POE_THREADS 128

// The experts, by value: expert m's element (b, d) is mu[m][b * mu_row[m] + d].
struct Experts {
  const float* mu[POE_MAX_EXPERTS];
  const float* lv[POE_MAX_EXPERTS];
  long long mu_row[POE_MAX_EXPERTS];
  long long lv_row[POE_MAX_EXPERTS];
};

struct SubsetMasks {
  int n_subsets;
  // bit m of members[s] is set when expert m belongs to subset s
  unsigned char members[POE_MAX_SUBSETS];
};

// Row s of the subset mask of m <= 3 experts in subset_powerset order (by
// size, then by member indices, as itertools.combinations gives them): bit
// j is set when expert j belongs to subset s.
__host__ __device__ constexpr unsigned powerset_row(int m, int s) {
  return m == 1   ? 1u
         : m == 2 ? (s < 2 ? 1u << s : 3u)
                  : (s < 3 ? 1u << s : s == 3 ? 3u : s == 4 ? 5u : s == 5 ? 6u : 7u);
}

// Forward over the power set of M experts. Thread i owns element (b, d).
template <int M, bool PRIOR>
__global__ void __launch_bounds__(POE_THREADS)
poe_subsets_f32_kernel(const Experts ex, float* __restrict__ mu_out, float* __restrict__ lv_out,
                       int batch, int dim, float prior_t) {
  constexpr int S = (1 << M) - 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * dim) return;  // ragged tail: any B works
  const int b = i / dim;
  const int d = i - b * dim;

  float mu[M], lv[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    mu[m] = __ldg(ex.mu[m] + b * ex.mu_row[m] + d);
    lv[m] = __ldg(ex.lv[m] + b * ex.lv_row[m] + d);
  }

  float t[M], mu_t[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    t[m] = 1.0f / (expf(lv[m]) + 1e-8f);
    mu_t[m] = __fmul_rn(mu[m], t[m]);
  }

  const long long n = (long long)batch * dim;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const unsigned bits = powerset_row(M, s);
    float t_sum = PRIOR ? prior_t : 0.0f;
    float mu_t_sum = 0.0f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
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

// Backward. For upstream gradients dmu_s, dlv_s [S, B, D] (contiguous) it
// recomputes, per (b, d), the experts' T_m and every subset's T_S and mu_S
// from the saved inputs, and accumulates over the subsets S that contain m
// (subsets in mask order, members ascending):
//
//   g      = dmu_S * (1 / T_S)
//   dmu_m += g * T_m
//   dT_m  += g * (mu_m - mu_S) - dlv_S * (1 / T_S)
//   dlv_m  = -dT_m * exp(lv_m) * T_m^2
//
// into dmu, dlv [M, B, D] (contiguous; slice m is expert m's gradient): the
// closed form of ops/fusion.poe_subsets_bwd, in its order of operations
// (FMA contraction allowed). Bound by bytes like the forward (2*S + 2*M
// floats read, 2*M written per element) and, like it, by latency at the
// model's shapes: every load is issued before any arithmetic.
template <int M, bool PRIOR>
__global__ void __launch_bounds__(POE_THREADS)
poe_subsets_bwd_f32_kernel(const Experts ex, const float* __restrict__ dmu_s,
                           const float* __restrict__ dlv_s, float* __restrict__ dmu,
                           float* __restrict__ dlv, int batch, int dim, float prior_t) {
  constexpr int S = (1 << M) - 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * dim) return;
  const int b = i / dim;
  const int d = i - b * dim;
  const long long n = (long long)batch * dim;

  float mu[M], lv[M], up_mu[S], up_lv[S];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    mu[m] = __ldg(ex.mu[m] + b * ex.mu_row[m] + d);
    lv[m] = __ldg(ex.lv[m] + b * ex.lv_row[m] + d);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    up_mu[s] = __ldg(dmu_s + s * n + i);
    up_lv[s] = __ldg(dlv_s + s * n + i);
  }

  float var[M], t[M], mu_t[M], g_mu[M], g_t[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    var[m] = expf(lv[m]);
    t[m] = 1.0f / (var[m] + 1e-8f);
    mu_t[m] = mu[m] * t[m];
    g_mu[m] = 0.0f;
    g_t[m] = 0.0f;
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    const unsigned bits = powerset_row(M, s);
    float t_sum = PRIOR ? prior_t : 0.0f;
    float mu_t_sum = 0.0f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (bits & (1u << m)) {
        t_sum += t[m];
        mu_t_sum += mu_t[m];
      }
    }
    const float inv = 1.0f / t_sum;
    const float mu_sub = mu_t_sum * inv;
    const float g = up_mu[s] * inv;
    const float g_lv = up_lv[s] * inv;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (bits & (1u << m)) {
        g_mu[m] += g * t[m];
        g_t[m] += g * (mu[m] - mu_sub) - g_lv;
      }
    }
  }

#pragma unroll
  for (int m = 0; m < M; ++m) {
    dmu[m * n + i] = g_mu[m];
    dlv[m * n + i] = -g_t[m] * var[m] * (t[m] * t[m]);
  }
}

// The generic layout: any M <= 8 experts and any subset rows, by value.
// One thread per (b, d), the subsets looped over at run time; the same
// arithmetic as the power-set kernels above.
__global__ void __launch_bounds__(POE_THREADS)
poe_subsets_generic_f32_kernel(const Experts ex, float* __restrict__ mu_out,
                               float* __restrict__ lv_out, int n_experts, int batch, int dim,
                               const SubsetMasks masks, float prior_t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * dim) return;
  const int b = i / dim;
  const int d = i - b * dim;

  float t[POE_MAX_EXPERTS];
  float mu_t[POE_MAX_EXPERTS];
#pragma unroll
  for (int m = 0; m < POE_MAX_EXPERTS; ++m) {
    t[m] = 0.0f;
    mu_t[m] = 0.0f;
    if (m < n_experts) {
      t[m] = 1.0f / (expf(__ldg(ex.lv[m] + b * ex.lv_row[m] + d)) + 1e-8f);
      mu_t[m] = __fmul_rn(__ldg(ex.mu[m] + b * ex.mu_row[m] + d), t[m]);
    }
  }

  const long long n = (long long)batch * dim;
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

__global__ void __launch_bounds__(POE_THREADS)
poe_subsets_generic_bwd_f32_kernel(const Experts ex, const float* __restrict__ dmu_s,
                                   const float* __restrict__ dlv_s, float* __restrict__ dmu,
                                   float* __restrict__ dlv, int n_experts, int batch, int dim,
                                   const SubsetMasks masks, float prior_t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * dim) return;
  const int b = i / dim;
  const int d = i - b * dim;

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
      mu[m] = __ldg(ex.mu[m] + b * ex.mu_row[m] + d);
      var[m] = expf(__ldg(ex.lv[m] + b * ex.lv_row[m] + d));
      t[m] = 1.0f / (var[m] + 1e-8f);
      mu_t[m] = mu[m] * t[m];
    }
  }

  const long long n = (long long)batch * dim;
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

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

namespace {

template <int M, bool P>
void launch_fwd(unsigned blocks, cudaStream_t stream, const Experts& ex, const float*,
                const float*, float* a, float* b, int batch, int dim, float prior_t) {
  poe_subsets_f32_kernel<M, P><<<blocks, POE_THREADS, 0, stream>>>(ex, a, b, batch, dim, prior_t);
}

template <int M, bool P>
void launch_bwd(unsigned blocks, cudaStream_t stream, const Experts& ex, const float* up_mu,
                const float* up_lv, float* dmu, float* dlv, int batch, int dim, float prior_t) {
  poe_subsets_bwd_f32_kernel<M, P><<<blocks, POE_THREADS, 0, stream>>>(ex, up_mu, up_lv, dmu,
                                                                       dlv, batch, dim, prior_t);
}

using Launcher = void (*)(unsigned, cudaStream_t, const Experts&, const float*, const float*,
                          float*, float*, int, int, float);

// [M - 1][prior]: every power-set instantiation
#define POE_INSTANTIATIONS(L) \
  {{L<1, false>, L<1, true>}, {L<2, false>, L<2, true>}, {L<3, false>, L<3, true>}}

const Launcher kForward[POE_POWERSET_MAX_EXPERTS][2] = POE_INSTANTIATIONS(launch_fwd);
const Launcher kBackward[POE_POWERSET_MAX_EXPERTS][2] = POE_INSTANTIATIONS(launch_bwd);

// Checks one call's arguments: cudaSuccess, or the cudaError_t to return.
// masks == nullptr selects the power-set layout of n_experts <= 3.
cudaError_t check_call(int n_experts, int batch, int dim, const SubsetMasks* masks) {
  if (n_experts < 1 || n_experts > POE_MAX_EXPERTS || batch < 0 || dim < 0 ||
      (long long)batch * dim > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  if (masks == nullptr ? n_experts > POE_POWERSET_MAX_EXPERTS
                       : (masks->n_subsets < 1 || masks->n_subsets > POE_MAX_SUBSETS)) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

unsigned grid(int batch, int dim) {
  return (unsigned)(((long long)batch * dim + POE_THREADS - 1) / POE_THREADS);
}

}  // namespace

// Forward: mu_out, lv_out [S, B, D] from the experts (read by the host
// call, passed to the kernel by value). `masks` is nullptr for
// the power set of n_experts <= 3 in subset_powerset order (S = 2^M - 1),
// else the subsets' member bitmasks (generic kernel). `prior` adds the
// N(0, I) expert of precision prior_t. Returns a cudaError_t as int: 0 on
// success, the argument or launch error otherwise.
extern "C" int poe_subsets_f32(const Experts* experts, float* mu_out, float* lv_out,
                               int n_experts, int batch, int dim, const SubsetMasks* masks,
                               int prior, float prior_t, cudaStream_t stream) {
  if (experts == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = check_call(n_experts, batch, dim, masks);
  if (err != cudaSuccess) return (int)err;
  if ((long long)batch * dim == 0) return 0;
  const Experts& ex = *experts;
  const unsigned blocks = grid(batch, dim);
  if (masks == nullptr) {
    kForward[n_experts - 1][prior ? 1 : 0](blocks, stream, ex, nullptr, nullptr, mu_out, lv_out,
                                           batch, dim, prior_t);
  } else {
    poe_subsets_generic_f32_kernel<<<blocks, POE_THREADS, 0, stream>>>(
        ex, mu_out, lv_out, n_experts, batch, dim, *masks, prior ? prior_t : 0.0f);
  }
  return (int)cudaGetLastError();
}

// Backward: dmu, dlv [M, B, D] from the experts and the upstream gradients
// dmu_s, dlv_s [S, B, D] (contiguous); arguments as for the forward.
extern "C" int poe_subsets_bwd_f32(const Experts* experts, const float* dmu_s,
                                   const float* dlv_s, float* dmu, float* dlv, int n_experts,
                                   int batch, int dim, const SubsetMasks* masks, int prior,
                                   float prior_t, cudaStream_t stream) {
  if (experts == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = check_call(n_experts, batch, dim, masks);
  if (err != cudaSuccess) return (int)err;
  if ((long long)batch * dim == 0) return 0;
  const Experts& ex = *experts;
  const unsigned blocks = grid(batch, dim);
  if (masks == nullptr) {
    kBackward[n_experts - 1][prior ? 1 : 0](blocks, stream, ex, dmu_s, dlv_s, dmu, dlv, batch,
                                            dim, prior_t);
  } else {
    poe_subsets_generic_bwd_f32_kernel<<<blocks, POE_THREADS, 0, stream>>>(
        ex, dmu_s, dlv_s, dmu, dlv, n_experts, batch, dim, *masks, prior ? prior_t : 0.0f);
  }
  return (int)cudaGetLastError();
}
