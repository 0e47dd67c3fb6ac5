// The batched victim search (K5): DefaultPreemption's selectVictimsOnNode
// for every (unschedulable pod u, node n) lane.
//
// Replaces the JAX package's preemption/kernel.py build_preempt_fn (:34),
// a jitted vmap(U) x vmap(N) whose per-lane body runs a fori_loop greedy
// reprieve over the V victim slots.  Here one thread runs one lane, in a
// grid over U x N; lanes share nothing.  Per lane, in the reference's
// order of operations (the plain version is preemption/kernel.py
// preempt_plain):
//
//   1. lower[s] = vvalid[n,s] && vprio[n,s] < uprio[u] (int64 compares);
//      n_lower, and freed[r] = the lower slots' requests summed;
//   2. usage = base_req[n] + extra_req[n] + the same-window successes
//      s with smask[u,s] && snode[s] == n (their count too);
//      free0 = alloc - (usage - freed); u fits with every lower pod gone
//      when each column it wants fits and cnt - n_lower + 1 <= max_pods;
//   3. PDB violation by budget rank: per budget k, a running count over
//      the lower slots it matches in slot order; slot s violates when some
//      matching k's count passes allowed[k] at s.  viol is written for
//      every lane, not masked by cand (as the reference returns it);
//   4. reprieve: the violating slots in slot order, then the others in
//      slot order; an active slot is re-added when u still fits with it
//      back, else it is a victim.  cand = cand0 && any victim; victims are
//      masked by cand.
//
// Exactness: the resource columns are GCD-scaled integers; the wrapper
// checks that every value and partial sum stays below 2^24 (float) or
// 2^53 (double) before it launches, so every sum is exact in any order.
// Built with --fmad=false and no fast math.  Priorities stay int64.
//
// What bounds it on an H100: neither bytes nor operations at the shapes
// of the path (U <= 64 pods x N = 5 000 nodes x V = 4 slots, R = 2): a few
// megabytes and a few hundred operations a lane.  The launch and each
// lane's serial loops (S same-window successes, V slots, PDB budgets) pace
// it.  A lane keeps its per-column sums in small local arrays (R <= MAXR
// columns) and streams the slot tables, which the U lanes of a node share
// through the caches; the per-PDB count is one running register per
// budget, and the viol row is read back from the thread's own writes.

#include <cstdint>
#include <cuda_runtime.h>

// the wrapper's ctypes mirror (ops/kernels.py PreemptArgs): every field 8
// bytes wide, in this order; outside the anonymous namespace so the C entry
// points that take it keep external linkage
struct PreemptArgs {
  int64_t U, N, V, R, PDB, S;
  const uint8_t* ucand;    // [U,N]
  const void* ureq;        // [U,R]
  const int64_t* uprio;    // [U]
  const uint8_t* smask;    // [U,S]
  const void* sreq;        // [S,R]
  const int32_t* snode;    // [S]
  const void* alloc;       // [N,R]
  const void* base_req;    // [N,R]
  const void* extra_req;   // [N,R]
  const void* base_cnt;    // [N]
  const void* extra_cnt;   // [N]
  const void* max_pods;    // [N]
  const void* vreq;        // [N,V,R]
  const int64_t* vprio;    // [N,V]
  const uint8_t* vvalid;   // [N,V]
  const uint8_t* vmatch;   // [N,V,PDB]
  const int32_t* allowed;  // [PDB]
  uint8_t* cand;           // [U,N]
  uint8_t* victims;        // [U,N,V]
  uint8_t* viol;           // [U,N,V]
};

namespace {

constexpr int THREADS = 128;
constexpr int MAXR = 16;  // resource columns of a lane's local arrays

template <typename T>
__device__ __forceinline__ bool fits_all(const T* want, const T* free0, const T* sub, int64_t R) {
  // every column u wants fits (a want <= 0 column is skipped, as the
  // oracle's Fit loop skips it)
  bool ok = true;
  for (int64_t r = 0; r < R; ++r) {
    const T avail = sub ? free0[r] - sub[r] : free0[r];
    ok = ok && ((want[r] <= avail) || (want[r] <= T(0)));
  }
  return ok;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) preempt_kernel(PreemptArgs a) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.U * a.N) return;
  const int64_t u = lane / a.N, n = lane - u * a.N;
  const int64_t V = a.V, R = a.R;
  const T* ureq = (const T*)a.ureq + u * R;
  const T* sreq = (const T*)a.sreq;
  const T* alloc = (const T*)a.alloc + n * R;
  const T* base_req = (const T*)a.base_req + n * R;
  const T* extra_req = (const T*)a.extra_req + n * R;
  const T* vreq = (const T*)a.vreq + n * V * R;
  const int64_t* vprio = a.vprio + n * V;
  const uint8_t* vvalid = a.vvalid + n * V;
  const int64_t prio = a.uprio[u];
  uint8_t* viol = a.viol + lane * V;
  uint8_t* victims = a.victims + lane * V;

  T want[MAXR], free0[MAXR], readd[MAXR], row[MAXR];
  // 1. lower slots, their count and freed requests
  T n_lower = T(0);
  for (int64_t r = 0; r < R; ++r) {
    want[r] = ureq[r];
    free0[r] = T(0);  // freed, until step 2
  }
  for (int64_t s = 0; s < V; ++s) {
    if (vvalid[s] && vprio[s] < prio) {
      n_lower += T(1);
      for (int64_t r = 0; r < R; ++r) free0[r] += vreq[s * R + r];
    }
  }
  // 2. usage with the same-window successes, free capacity, fit with
  //    every lower pod removed
  T cnt = ((const T*)a.base_cnt)[n] + ((const T*)a.extra_cnt)[n];
  T usage[MAXR];
  for (int64_t r = 0; r < R; ++r) usage[r] = base_req[r] + extra_req[r];
  const uint8_t* smask = a.smask + u * a.S;
  for (int64_t s = 0; s < a.S; ++s) {
    if (smask[s] && a.snode[s] == n) {
      for (int64_t r = 0; r < R; ++r) usage[r] += sreq[s * R + r];
      cnt += T(1);
    }
  }
  for (int64_t r = 0; r < R; ++r) free0[r] = alloc[r] - (usage[r] - free0[r]);
  const T maxp = ((const T*)a.max_pods)[n];
  const bool cand0 = a.ucand[lane] && fits_all(want, free0, (const T*)nullptr, R) &&
                     (cnt - n_lower + T(1) <= maxp) && (n_lower >= T(1));

  // 3. PDB violations by budget rank, in slot order
  for (int64_t s = 0; s < V; ++s) viol[s] = 0;
  if (a.PDB > 0) {
    const uint8_t* vmatch = a.vmatch + n * V * a.PDB;
    for (int64_t k = 0; k < a.PDB; ++k) {
      const int32_t budget = a.allowed[k];
      int32_t running = 0;
      for (int64_t s = 0; s < V; ++s) {
        if (vmatch[s * a.PDB + k] && vvalid[s] && vprio[s] < prio) {
          running += 1;
          if (running > budget) viol[s] = 1;
        }
      }
    }
  }

  // 4. greedy reprieve: violating slots first, then the others, each in
  //    slot order
  for (int64_t r = 0; r < R; ++r) readd[r] = T(0);
  T readd_cnt = T(0);
  bool any = false;
  for (int pass = 0; pass < 2; ++pass) {
    for (int64_t s = 0; s < V; ++s) {
      const bool v = viol[s] != 0;
      if (v != (pass == 0)) continue;
      const bool active = vvalid[s] && vprio[s] < prio;
      if (!active) {
        victims[s] = 0;
        continue;
      }
      for (int64_t r = 0; r < R; ++r) row[r] = readd[r] + vreq[s * R + r];
      const bool ok = fits_all(want, free0, row, R) && (cnt - n_lower + readd_cnt + T(2) <= maxp);
      if (ok) {
        for (int64_t r = 0; r < R; ++r) readd[r] = row[r];
        readd_cnt += T(1);
      }
      victims[s] = ok ? 0 : 1;
      any = any || !ok;
    }
  }
  const bool cand = cand0 && any;
  a.cand[lane] = cand ? 1 : 0;
  if (!cand) {
    for (int64_t s = 0; s < V; ++s) victims[s] = 0;
  }
}

template <typename T>
int launch(const PreemptArgs* a, void* stream) {
  if (a->R > MAXR) return (int)cudaErrorInvalidValue;
  const int64_t lanes = a->U * a->N;
  if (lanes == 0) return (int)cudaSuccess;
  const int64_t blocks = (lanes + THREADS - 1) / THREADS;
  preempt_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kss_preempt_f32(const PreemptArgs* a, void* stream) { return launch<float>(a, stream); }
extern "C" int kss_preempt_f64(const PreemptArgs* a, void* stream) { return launch<double>(a, stream); }
