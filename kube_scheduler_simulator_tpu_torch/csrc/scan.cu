// The batch scheduling scan: one launch runs the whole pod loop of a round.
//
// Replaces the JAX package's ops/batch.py build_batch_fn: the pairwise
// feature expansion _expand_features (:1702-1721, here per-pod-row gathers
// from the class matrices, never a [P,N] plane), the per-pod step under
// lax.scan (:1264-1700: filters with first-failure tracking, the rotated
// feasible-node sampling prefix sum, five scores with their normalization,
// selection by first visit rank or the reservoir draw, the commit) and the
// packed outputs and trace meta of _scan (:1723-1780).
//
// What bounds it on an H100: the sequential dependency chain.  Pod i+1's
// filters read the carry pod i committed, so the P steps run one after the
// other, each a handful of passes over N nodes with block-wide scans and
// reductions between them; the per-step latency (barriers, L1/L2 round
// trips of the carry) sets the pace, far above both the bytes it must move
// (the [P,N] trace planes) and its operations.
//
// Design: every block runs the full pod loop on its own copy of the carry
// (deterministic, identical arithmetic in every block, no atomics, one
// writer per node at the commit), and the blocks split only the output
// rows: block b writes the trace planes of pods i with i % gridDim.x == b.
// So the chain runs at one block's speed while the trace writes, the bulk
// of the bytes, spread over every SM.  On an H100 at 10 000 pods x 5 000
// nodes, one block writing every row took 11 % longer in float32 and 8 %
// in float64 (time_scan.py launches this kernel with one block).  Nodes are visited in rotation order
// (rank r -> node (start + r) % n_true, padding columns after), so the
// rotated prefix sum is a plain running block scan.
//
// Exactness: built with --fmad=false and without fast math; every formula
// keeps the reference's order of operations, divisions are IEEE divisions,
// quotients go through floor/trunc, and the reservoir hash is uint32.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAXF = 8;
constexpr int MAXS = 8;
constexpr int MAXFR = 4;
constexpr int MAXSHAPE = 16;

enum { F_UNSCHED = 0, F_NAME = 1, F_TAINT = 2, F_AFF = 3, F_FIT = 4 };
enum { S_FIT = 0, S_BAL = 1, S_IMG = 2, S_TAINT = 3, S_AFF = 4 };
enum { FIT_LEAST = 0, FIT_MOST = 1, FIT_RTCR = 2 };

}  // namespace

// Every field is 8 bytes wide, so the layout matches the ctypes mirror in
// ops/kernels.py without padding rules.
struct ScanArgs {
  int64_t P, N, R, n_true, sample_k, start0, tb_base, seed_mix;
  int64_t trace, reservoir;
  int64_t nf, filters[MAXF];
  int64_t ns, scores[MAXS];
  double weights[MAXS];
  int64_t fit_strategy, n_fit_res, fit_col[MAXFR];
  double fit_w[MAXFR];
  double fit_wsum;
  int64_t n_shape, shape_u[MAXSHAPE], shape_s[MAXSHAPE];
  int64_t T_cols, M_cols, MP_cols, MC_cols;
  const void* alloc;
  const void* max_pods;
  const void* nz_alloc;
  const void* pod_req;
  const void* pod_nonzero;
  const uint8_t* fit_checked;
  const int16_t* taint_cls;
  const int16_t* taint_prefer_cls;
  const uint8_t* taint_unsched_cls;
  const int32_t* pod_tol_idx;
  const int32_t* node_taint_idx;
  const uint8_t* node_unsched;
  const int8_t* aff_code_cls;
  const int32_t* aff_pref_cls;
  const int32_t* pod_aff_idx;
  const int32_t* pod_pref_idx;
  const int32_t* node_label_idx;
  const int8_t* img_cls;
  const int32_t* pod_img_idx;
  const int32_t* node_img_idx;
  const int32_t* name_target;
  const uint8_t* pod_active;
  const uint8_t* node_active;
  const void* requested0;
  const void* nonzero0;
  const void* pod_count0;
  void* s_requested;   // [B,N,R] per-block carry
  void* s_nonzero;     // [B,N,2]
  void* s_pod_count;   // [B,N]
  void* s_total;       // [B,N] masked weighted totals of the current pod
  uint8_t* s_flags;    // [B,N] bit 0 feasible, bit 1 sampled
  int32_t* packed;     // [5,P]
  int32_t* final_start;  // [1]
  void* final_requested;
  void* final_nonzero;
  void* final_pod_count;
  int8_t* fail_plug;   // [P,N]
  int32_t* fail_code;  // [P,N]
  uint8_t* feasible;   // [P,N]
  void* raw[MAXS];     // [P,N] each
  void* norm[MAXS];    // [P,N] each
  int32_t* trace_meta; // [S+1,2]
};

namespace {

template <typename V, typename Op>
__device__ V block_reduce(V v, V identity, Op op) {
  __shared__ V sh[32];
  __shared__ V result;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) sh[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < nw ? sh[lane] : identity;
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) result = v;
  }
  __syncthreads();
  const V out = result;
  __syncthreads();
  return out;
}

// Inclusive prefix sum over the block in thread order; *total gets the sum.
__device__ int block_scan(int v, int* total) {
  __shared__ int sh[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) sh[w] = v;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? sh[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sh[lane] = s;
  }
  __syncthreads();
  const int out = v + (w > 0 ? sh[w - 1] : 0);
  *total = sh[nw - 1];
  __syncthreads();
  return out;
}

struct MaxOp {
  template <typename V>
  __device__ V operator()(V a, V b) const { return a > b ? a : b; }
};
struct MinOp {
  template <typename V>
  __device__ V operator()(V a, V b) const { return a < b ? a : b; }
};
struct SumOp {
  template <typename V>
  __device__ V operator()(V a, V b) const { return a + b; }
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// float/double overloads of the rounding functions
__device__ __forceinline__ float d_floor(float x) { return floorf(x); }
__device__ __forceinline__ double d_floor(double x) { return ::floor(x); }
__device__ __forceinline__ float d_trunc(float x) { return truncf(x); }
__device__ __forceinline__ double d_trunc(double x) { return ::trunc(x); }
__device__ __forceinline__ float d_fabs(float x) { return fabsf(x); }
__device__ __forceinline__ double d_fabs(double x) { return ::fabs(x); }

// Go integer division for non-negative operands, in floats:
// floor(a / where(b == 0, 1, b)) * (b != 0).
template <typename T>
__device__ __forceinline__ T floordiv(T a, T b) {
  return d_floor(a / (b == T(0) ? T(1) : b)) * (b != T(0) ? T(1) : T(0));
}

template <typename T>
__device__ __forceinline__ T truncdiv(T a, T b) {
  return d_trunc(a / (b == T(0) ? T(1) : b)) * (b != T(0) ? T(1) : T(0));
}

// helper.DefaultNormalizeScore given the max over the sampled nodes.
template <typename T>
__device__ __forceinline__ T default_normalize(T raw, T mx, bool reverse) {
  const T scaled = floordiv(raw * T(100), mx);
  const T out = reverse ? T(100) - scaled : scaled;
  return mx == T(0) ? (reverse ? T(100) : T(0)) : out;
}

template <typename T>
__device__ T broken_linear(T p, const ScanArgs& a) {
  T out = T(a.shape_s[a.n_shape - 1]);
  for (int k = (int)a.n_shape - 1; k >= 0; --k) {
    const int64_t u = a.shape_u[k], s = a.shape_s[k];
    T v;
    if (k == 0) {
      v = T(s);
    } else {
      const int64_t u0 = a.shape_u[k - 1], s0 = a.shape_s[k - 1];
      const int64_t du = u - u0 > 1 ? u - u0 : 1;
      v = T(s0) + truncdiv(T(s - s0) * (p - T(u0)), T(du));
    }
    if (p <= T(u)) out = v;
  }
  return out;
}

template <typename T>
__device__ T fit_score(const ScanArgs& a, const T* nz, const T* nz_alloc, const T* pnz) {
  T sum = T(0);
  for (int j = 0; j < a.n_fit_res; ++j) {
    const int c = (int)a.fit_col[j];
    const T req = nz[c] + pnz[c];
    const T al = nz_alloc[c];
    const bool fits = al > T(0) && req <= al;
    T per;
    if (a.fit_strategy == FIT_MOST) {
      per = fits ? floordiv(req * T(100), al) : T(0);
    } else if (a.fit_strategy == FIT_RTCR) {
      per = broken_linear(fits ? floordiv(req * T(100), al) : T(100), a);
    } else {
      per = fits ? floordiv((al - req) * T(100), al) : T(0);
    }
    sum = sum + per * T(a.fit_w[j]);
  }
  return floordiv(sum, T(a.fit_wsum));
}

template <typename T>
__device__ T balanced_score(const T* nz, const T* nz_alloc, const T* pnz) {
  T frac[2];
  for (int c = 0; c < 2; ++c) {
    const T req = nz[c] + pnz[c];
    const T al = nz_alloc[c];
    const T q = req / (al == T(0) ? T(1) : al);
    frac[c] = al > T(0) ? (q < T(1) ? q : T(1)) : T(1);
  }
  const T spread = d_fabs(frac[0] - frac[1]) / T(2);
  return d_floor((T(1) - spread) * T(100));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) scan_kernel(const ScanArgs a) {
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int B = gridDim.x;
  const int64_t P = a.P, N = a.N, R = a.R;
  const int nt = (int)a.n_true;
  const int K = (int)a.sample_k;
  const T* alloc = (const T*)a.alloc;
  const T* max_pods = (const T*)a.max_pods;
  const T* nz_alloc = (const T*)a.nz_alloc;
  const T* pod_req = (const T*)a.pod_req;
  const T* pod_nonzero = (const T*)a.pod_nonzero;
  T* req = (T*)a.s_requested + (int64_t)b * N * R;
  T* nzc = (T*)a.s_nonzero + (int64_t)b * N * 2;
  T* pc = (T*)a.s_pod_count + (int64_t)b * N;
  T* tot = (T*)a.s_total + (int64_t)b * N;
  uint8_t* fl = a.s_flags + (int64_t)b * N;
  const T NEG = T(-1e18);

  for (int64_t j = tid; j < N * R; j += blockDim.x) req[j] = ((const T*)a.requested0)[j];
  for (int64_t j = tid; j < N * 2; j += blockDim.x) nzc[j] = ((const T*)a.nonzero0)[j];
  for (int64_t j = tid; j < N; j += blockDim.x) pc[j] = ((const T*)a.pod_count0)[j];
  __syncthreads();

  // trace meta (block 0): per-score min/max of where(feasible & active,
  // raw, 0) over [P,N], and the max failure code
  T meta_mn[MAXS], meta_mx[MAXS];
  for (int k = 0; k < MAXS; ++k) {
    meta_mn[k] = T(INFINITY);
    meta_mx[k] = T(-INFINITY);
  }
  int code_mx = 0;
  const bool meta = a.trace && b == 0;

  int start = (int)a.start0;
  for (int64_t i = 0; i < P; ++i) {
    const bool owner = (i % B) == b;
    const bool writes = a.trace && owner;
    const bool active = a.pod_active[i] != 0;
    const int tol = a.pod_tol_idx[i];
    const int affi = a.pod_aff_idx[i];
    const int prefi = a.pod_pref_idx[i];
    const int imgi = a.pod_img_idx[i];
    const int tgt = a.name_target[i];
    const T* preq = pod_req + i * R;
    const T* pnz = pod_nonzero + i * 2;
    const uint8_t* fchk = a.fit_checked + i * R;

    // ---- pass 1: filters, rotated prefix sum, sampling ----------------
    int run = 0;
    int kth_rank = -1;
    T mx_taint = -INFINITY, mx_aff = -INFINITY;
    for (int64_t base = 0; base < N; base += blockDim.x) {
      const int r = (int)(base + tid);
      int n = -1;
      int feas = 0;
      if (r < N) {
        n = r < nt ? (start + r) % nt : r;
        const int ntaint = a.node_taint_idx[n];
        const int nlabel = a.node_label_idx[n];
        bool ok = a.node_active[n] != 0;
        int plug = -1, fcode = 0;
        for (int k = 0; k < a.nf; ++k) {
          int code = 0;
          switch ((int)a.filters[k]) {
            case F_UNSCHED: {
              const bool uok = a.node_unsched[n] == 0 ||
                               a.taint_unsched_cls[(int64_t)tol * a.T_cols + ntaint] != 0;
              code = uok ? 0 : 1;
              break;
            }
            case F_NAME:
              code = (tgt == -1 || tgt == n) ? 0 : 1;
              break;
            case F_TAINT: {
              const int tf = a.taint_cls[(int64_t)tol * a.T_cols + ntaint];
              code = tf < 0 ? 0 : tf + 1;
              break;
            }
            case F_AFF:
              code = a.aff_code_cls[(int64_t)affi * a.M_cols + nlabel];
              break;
            case F_FIT: {
              code = (pc[n] + T(1) > max_pods[n]) ? 1 : 0;
              for (int64_t q = 0; q < R; ++q) {
                const T fr = alloc[n * R + q] - req[n * R + q];
                if (preq[q] > fr && fchk[q]) code |= 1 << (q + 1);
              }
              break;
            }
          }
          if (plug < 0 && code != 0) {
            plug = k;
            fcode = code;
          }
          ok = ok && code == 0;
        }
        feas = ok ? 1 : 0;
        if (writes) {
          a.fail_plug[i * N + n] = (int8_t)plug;
          a.fail_code[i * N + n] = fcode;
        }
        if (meta && fcode > code_mx) code_mx = fcode;
      }
      int tile_total;
      const int c = run + block_scan(feas, &tile_total);
      run += tile_total;
      if (r < N) {
        const bool samp = feas && c <= K;
        if (feas && c == K) kth_rank = r;
        fl[n] = (uint8_t)(feas | (samp ? 2 : 0));
        const int64_t tcell = (int64_t)tol * a.T_cols + a.node_taint_idx[n];
        const T vt = samp ? T(a.taint_prefer_cls[tcell]) : T(0);
        const T va = samp ? T(a.aff_pref_cls[(int64_t)prefi * a.MP_cols + a.node_label_idx[n]]) : T(0);
        mx_taint = vt > mx_taint ? vt : mx_taint;
        mx_aff = va > mx_aff ? va : mx_aff;
      }
    }
    const int total = run;
    kth_rank = block_reduce(kth_rank, -1, MaxOp());
    mx_taint = block_reduce(mx_taint, T(-INFINITY), MaxOp());
    mx_aff = block_reduce(mx_aff, T(-INFINITY), MaxOp());
    const int processed = total >= K ? kth_rank + 1 : nt;
    const int count = (total < K ? total : K) * (active ? 1 : 0);

    // ---- pass 2: scores, weighted totals -------------------------------
    T best = -INFINITY;
    for (int64_t base = 0; base < N; base += blockDim.x) {
      const int r = (int)(base + tid);
      if (r < N) {
        const int n = r < nt ? (start + r) % nt : r;
        const bool samp = (fl[n] & 2) != 0;
        const int ntaint = a.node_taint_idx[n];
        const int nlabel = a.node_label_idx[n];
        T total_w = T(0);
        for (int k = 0; k < a.ns; ++k) {
          T raw, nrm;
          switch ((int)a.scores[k]) {
            case S_FIT:
              raw = fit_score(a, nzc + n * 2, nz_alloc + n * 2, pnz);
              nrm = raw;
              break;
            case S_BAL:
              raw = balanced_score(nzc + n * 2, nz_alloc + n * 2, pnz);
              nrm = raw;
              break;
            case S_IMG:
              raw = T(a.img_cls[(int64_t)imgi * a.MC_cols + a.node_img_idx[n]]);
              nrm = raw;
              break;
            case S_TAINT:
              raw = T(a.taint_prefer_cls[(int64_t)tol * a.T_cols + ntaint]);
              nrm = default_normalize(raw, mx_taint, true);
              break;
            default:  // S_AFF
              raw = T(a.aff_pref_cls[(int64_t)prefi * a.MP_cols + nlabel]);
              nrm = default_normalize(raw, mx_aff, false);
              break;
          }
          if (writes) {
            ((T*)a.raw[k])[i * N + n] = raw;
            ((T*)a.norm[k])[i * N + n] = nrm;
          }
          if (meta) {
            const T v = (samp && active) ? raw : T(0);
            meta_mn[k] = v < meta_mn[k] ? v : meta_mn[k];
            meta_mx[k] = v > meta_mx[k] ? v : meta_mx[k];
          }
          total_w = total_w + nrm * T(a.weights[k]);
        }
        const T masked = samp ? total_w : NEG;
        tot[n] = masked;
        best = masked > best ? masked : best;
        if (writes) a.feasible[i * N + n] = samp ? 1 : 0;
      }
    }
    best = block_reduce(best, T(-INFINITY), MaxOp());

    // ---- pass 3: selection ----------------------------------------------
    int sel_node = -1;
    if (!a.reservoir) {
      // first tied maximum in visit order = minimal visit rank
      int best_rank = 0x7fffffff;
      for (int64_t base = 0; base < N; base += blockDim.x) {
        const int r = (int)(base + tid);
        if (r < N) {
          const int n = r < nt ? (start + r) % nt : r;
          if ((fl[n] & 2) && tot[n] == best && r < best_rank) best_rank = r;
        }
      }
      best_rank = block_reduce(best_rank, 0x7fffffff, MinOp());
      if (best_rank != 0x7fffffff) sel_node = best_rank < nt ? (start + best_rank) % nt : best_rank;
    } else {
      // k-th tied maximum in visit order, k from the counter-keyed draw
      int tied_cnt = 0;
      for (int64_t base = 0; base < N; base += blockDim.x) {
        const int r = (int)(base + tid);
        if (r < N) {
          const int n = r < nt ? (start + r) % nt : r;
          if ((fl[n] & 2) && tot[n] == best) ++tied_cnt;
        }
      }
      const int t_count = block_reduce(tied_cnt, 0, SumOp());
      const uint32_t counter = (uint32_t)((uint64_t)a.tb_base + (uint64_t)i);
      const uint32_t draw = mix32((uint32_t)a.seed_mix ^ mix32(counter));
      const int kk = (int)(draw % (uint32_t)(t_count > 1 ? t_count : 1));
      int seen = 0;
      int pick = -1;
      for (int64_t base = 0; base < N; base += blockDim.x) {
        const int r = (int)(base + tid);
        int tied = 0, n = -1;
        if (r < N) {
          n = r < nt ? (start + r) % nt : r;
          tied = ((fl[n] & 2) && tot[n] == best) ? 1 : 0;
        }
        int tile_total;
        const int ct = seen + block_scan(tied, &tile_total);
        seen += tile_total;
        if (tied && ct == kk + 1) pick = n;
      }
      sel_node = block_reduce(pick, -1, MaxOp());
    }
    const int sel = count > 0 ? sel_node : -1;

    // ---- commit: one writer per node ------------------------------------
    if (sel >= 0 && tid == 0) {
      for (int64_t q = 0; q < R; ++q) req[sel * R + q] = req[sel * R + q] + T(1) * preq[q];
      nzc[sel * 2 + 0] = nzc[sel * 2 + 0] + T(1) * pnz[0];
      nzc[sel * 2 + 1] = nzc[sel * 2 + 1] + T(1) * pnz[1];
      pc[sel] = pc[sel] + T(1);
    }
    if (owner && tid == 0) {
      a.packed[0 * P + i] = sel;
      a.packed[1 * P + i] = count;
      a.packed[2 * P + i] = start;
      a.packed[3 * P + i] = processed;
    }
    // the rotating start advances by the number of visited nodes
    if (active) start = nt > 0 ? (start + processed) % nt : 0;
    __syncthreads();
  }

  if (b != 0) return;
  for (int64_t i = tid; i < P; i += blockDim.x) a.packed[4 * P + i] = start;
  if (tid == 0) a.final_start[0] = start;
  for (int64_t j = tid; j < N * R; j += blockDim.x) ((T*)a.final_requested)[j] = req[j];
  for (int64_t j = tid; j < N * 2; j += blockDim.x) ((T*)a.final_nonzero)[j] = nzc[j];
  for (int64_t j = tid; j < N; j += blockDim.x) ((T*)a.final_pod_count)[j] = pc[j];
  if (!a.trace) return;
  for (int k = 0; k < a.ns; ++k) {
    const T mn = block_reduce(meta_mn[k], T(INFINITY), MinOp());
    const T mx = block_reduce(meta_mx[k], T(-INFINITY), MaxOp());
    if (tid == 0) {
      a.trace_meta[2 * k] = (int32_t)mn;
      a.trace_meta[2 * k + 1] = (int32_t)mx;
    }
  }
  code_mx = block_reduce(code_mx, 0, MaxOp());
  if (tid == 0) {
    a.trace_meta[2 * a.ns] = 0;
    a.trace_meta[2 * a.ns + 1] = a.nf > 0 ? code_mx : 0;
  }
}

template <typename T>
int launch(const ScanArgs* a, int64_t blocks, void* stream) {
  scan_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kss_scan_f32(const ScanArgs* a, int64_t blocks, void* stream) { return launch<float>(a, blocks, stream); }
extern "C" int kss_scan_f64(const ScanArgs* a, int64_t blocks, void* stream) { return launch<double>(a, blocks, stream); }
