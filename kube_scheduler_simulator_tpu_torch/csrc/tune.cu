// The tuner's objective kernel (part of K9): each lane of a rollout reduced
// to its objective's scalar, and (backward mode) the objective's cotangent
// F = d objective / d final_nonzero; and K2g's contraction of F with the
// residual M [2,S,N] that the scan's grad mode folded over the pod chain:
// dw_k = (sum over m = 2n + j of F[n,j] M[j,k,n]) / tau, one block a
// weight, the products (in float64) summed over the same fixed tree.
//
// Replaces the JAX package's tuning/objective.py:33-87 (utilization,
// fragmentation, pending_age), which XLA fuses into the rollout's jit, and
// their autodiff in tuning/relax.py:63-71.  One block a lane:
//
// - utilization: f = (cap > 0 & node active) ? used / cap : 0 over the
//   [N,2] final_nonzero, J = sum f^2 / (sum f == 0 ? 1 : sum f);
// - fragmentation: J = -sum |f0 - f1| active / max(sum active, 1);
// - pending_age: J = -sum age_w (selected < 0 & pod active) / max(sum
//   age_w, 1e-9).
//
// Every sum runs over a fixed pairwise tree: the values padded with zeros
// to a power of two `pw`, then x[j] = x[j] + x[j + h] for h = pw/2, pw/4,
// ..., 1, one level between two barriers, in per-lane global scratch.  The
// plain version (tuning/objective.py, tree_sum) adds in the same tree, so
// kernel and plain version are bitwise equal and a CPU and a CUDA float64
// tuner rank a population alike.  Backward (one lane): utilization's
// df = 2 f / S' + (S != 0 ? -(A / S') / S' : 0), with S' the guarded sum
// and A the sum of squares, and F = cond ? df / den : 0; fragmentation's
// g = (-1 / n) active s with s = (f0 - f1 >= 0 ? 1 : -1), the derivative
// JAX's abs takes (select(x >= 0, g, -g): +1 at 0, so an empty active node
// has one too), F0 = cond0 ? g / den0 : 0, F1 = cond1 ? -g / den1 : 0;
// pending_age's F is 0 (the selections carry no gradient).
//
// What bounds it on an H100: launch latency.  It moves N*2 or P values a
// lane and does a few operations on each; log2(pw) barriers a lane.
//
// Exactness: built with --fmad=false and without fast math; divisions are
// IEEE divisions, in the plain version's order of operations.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
enum { O_UTIL = 0, O_FRAG = 1, O_AGE = 2 };

}  // namespace

// Every field is 8 bytes wide, so the layout matches the ctypes mirror in
// ops/kernels.py without padding rules.
struct ObjArgs {
  int64_t L, N, P;
  int64_t kind;      // O_UTIL, O_FRAG, O_AGE
  int64_t backward;  // 1: write F [L,N,2] instead of the value
  int64_t pw;        // the tree's width: a power of two >= the values summed
  const void* used;            // [L,N,2] final_nonzero
  const void* nz_alloc;        // [N,2]
  const uint8_t* node_active;  // [N]
  const int32_t* selected;     // [L,P]
  const uint8_t* pod_active;   // [P]
  const void* age_w;           // [P]
  void* scratch;               // [L,2,pw]
  void* value;                 // [L]
  void* F;                     // [L,N,2]
};

struct ContractArgs {
  int64_t S, N;
  int64_t pw;          // the tree's width: a power of two >= 2N
  double tau;
  const void* F;       // [N,2] d objective / d final_nonzero
  const double* M;     // [2,S,N] the grad forward's residual
  double* scratch;     // [S,pw]
  double* dw;          // [S] d objective / d weights
};

namespace {

// The tree sum of buf[0:pw] (filled by the caller, visible after the
// first barrier); buf is consumed.
template <typename T>
__device__ T tree_sum(T* buf, int64_t pw) {
  for (int64_t h = pw / 2; h >= 1; h /= 2) {
    __syncthreads();
    for (int64_t j = threadIdx.x; j < h; j += blockDim.x) buf[j] = buf[j] + buf[j + h];
  }
  __syncthreads();
  const T r = buf[0];
  __syncthreads();
  return r;
}

// used / den where the node allocates the column and is active, else 0
template <typename T>
__device__ __forceinline__ T used_frac(const T* used, const T* cap, const uint8_t* act, int64_t j) {
  const T c = cap[j];
  const T q = used[j] / (c == T(0) ? T(1) : c);
  return (c > T(0) && act[j / 2]) ? q : T(0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) objective_kernel(const ObjArgs a) {
  const int64_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t N = a.N, P = a.P, pw = a.pw;
  const T* used = (const T*)a.used + lane * N * 2;
  const T* cap = (const T*)a.nz_alloc;
  const uint8_t* act = a.node_active;
  T* b1 = (T*)a.scratch + lane * 2 * pw;
  T* b2 = b1 + pw;
  const int64_t n_vals = a.kind == O_UTIL ? N * 2 : (a.kind == O_FRAG ? N : P);
  for (int64_t j = tid; j < pw; j += blockDim.x) {
    T v1 = T(0), v2 = T(0);
    if (j < n_vals) {
      if (a.kind == O_UTIL) {
        const T f = used_frac(used, cap, act, j);
        v1 = f;
        v2 = f * f;
      } else if (a.kind == O_FRAG) {
        const T av = act[j] ? T(1) : T(0);
        const T d = used_frac(used, cap, act, 2 * j) - used_frac(used, cap, act, 2 * j + 1);
        v1 = av;
        v2 = (d < T(0) ? -d : d) * av;
      } else {
        const T w = ((const T*)a.age_w)[j];
        const bool pending = a.selected[lane * P + j] < 0 && a.pod_active[j];
        v1 = w;
        v2 = w * (pending ? T(1) : T(0));
      }
    }
    b1[j] = v1;
    b2[j] = v2;
  }
  const T s1 = tree_sum(b1, pw);
  const T s2 = tree_sum(b2, pw);
  if (!a.backward) {
    if (tid == 0) {
      T v;
      if (a.kind == O_UTIL) {
        v = s2 / (s1 == T(0) ? T(1) : s1);
      } else if (a.kind == O_FRAG) {
        v = -s2 / (s1 > T(1) ? s1 : T(1));
      } else {
        v = -s2 / (s1 > T(1e-9) ? s1 : T(1e-9));
      }
      ((T*)a.value)[lane] = v;
    }
    return;
  }
  T* F = (T*)a.F + lane * N * 2;
  for (int64_t j = tid; j < N * 2; j += blockDim.x) {
    const T c = cap[j];
    const bool cond = c > T(0) && act[j / 2];
    const T den = c == T(0) ? T(1) : c;
    T df = T(0);
    if (a.kind == O_UTIL) {
      const T sp = s1 == T(0) ? T(1) : s1;
      const T gS = s1 != T(0) ? (-s2 / sp) / sp : T(0);
      df = T(2) * used_frac(used, cap, act, j) * (T(1) / sp) + gS;
    } else if (a.kind == O_FRAG) {
      const int64_t n = j / 2;
      const T d = used_frac(used, cap, act, 2 * n) - used_frac(used, cap, act, 2 * n + 1);
      const T sg = d >= T(0) ? T(1) : T(-1);
      const T g = T(-1) / (s1 > T(1) ? s1 : T(1)) * (act[n] ? T(1) : T(0)) * sg;
      df = (j % 2 == 0) ? g : -g;
    }
    F[j] = cond ? df / den : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) contract_kernel(const ContractArgs a) {
  const int64_t k = blockIdx.x, N = a.N, pw = a.pw;
  const T* F = (const T*)a.F;
  double* buf = a.scratch + k * pw;
  for (int64_t m = threadIdx.x; m < pw; m += blockDim.x) {
    buf[m] = m < 2 * N ? (double)F[m] * a.M[((m % 2) * a.S + k) * N + m / 2] : 0.0;
  }
  const double s = tree_sum(buf, pw);
  if (threadIdx.x == 0) a.dw[k] = s / a.tau;
}

template <typename T>
int launch_contract(const ContractArgs* a, void* stream) {
  if (a->S < 1 || a->S > 65535 || a->N < 1 || a->pw < 2 * a->N || !(a->tau > 0)) return (int)cudaErrorInvalidValue;
  contract_kernel<T><<<(unsigned)a->S, THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const ObjArgs* a, void* stream) {
  if (a->L < 1 || a->L > 65535 || a->kind < O_UTIL || a->kind > O_AGE || a->pw < 1) return (int)cudaErrorInvalidValue;
  objective_kernel<T><<<(unsigned)a->L, THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kss_objective_f32(const ObjArgs* a, void* stream) { return launch<float>(a, stream); }
extern "C" int kss_objective_f64(const ObjArgs* a, void* stream) { return launch<double>(a, stream); }
extern "C" int kss_contract_f32(const ContractArgs* a, void* stream) { return launch_contract<float>(a, stream); }
extern "C" int kss_contract_f64(const ContractArgs* a, void* stream) { return launch_contract<double>(a, stream); }
