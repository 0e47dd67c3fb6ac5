// The gang kernels: the per-window verdict (K6) and the all-or-nothing
// feasibility scan (K7).  Their plain versions are gang/kernel.py
// verdict_plain and feasibility_plain.
//
// K6 replaces the JAX package's gang/kernel.py build_verdict_fn (:43), a
// jitted scatter-add of placed and failed members into [G] counters and a
// scatter-max of placed members' domains into a [G,D] table.  Here one
// launch, no memset and no global atomic:
//
//   - a block takes a range of gb groups whose counters (placed, failed)
//     and domain bitmaps (ceil(D/32) words a group) fit its shared memory,
//     and zeroes them;
//   - its threads stride over the K member slots.  A slot whose group lies
//     outside the block's range (a pad, gid -1, included) adds nothing.  A
//     placed member (node[k] >= 0) adds 1 to placed[g] and sets bit
//     dom[g, node[k]] of group g's bitmap; a failed one adds 1 to its
//     failed count.  Shared-memory atomicAdd and atomicOr on integers
//     commute, so the result does not depend on the order the slots land
//     in;
//   - a warp a group then writes distinct = the popcount of its bitmap,
//     placed, and feasible = failed == 0 && placed + prior_bound >=
//     min_member.  All int32: nothing rounds.
//
// The outputs are three slices of one buffer the wrapper hands in
// (distinct, placed int32, then feasible bytes), so the dispatch fetches
// them in one copy.  At the gang path's shapes (K a few hundred member
// slots, G 40, D 8) a single block does everything; several blocks appear
// only when G x ceil(D/32) outgrows one block's budget, and each of them
// rereads the slot arrays (kilobytes).
//
// What bounds K6 on an H100: the launch.  Its bytes (the slots, the domain
// cell of each placed member, the per-group inputs and outputs) are
// kilobytes, well under a microsecond at 3.35 TB/s.
//
// K7 replaces the JAX package's gang/kernel.py build_feasibility_fn (:108),
// a vmap over the G groups of a lax.scan over each group's M member slots.
// The groups are independent and each starts from the same free capacity,
// so one block runs one group.  Its copy of free[N,R], cnt_free[N] and a
// used-domain flag per domain sits in shared memory when it fits (N 5 000
// x R 2 in double with D 5 000 flags is 125 KB), else in a per-group slice
// of a global scratch the wrapper allocates.  Per slot m, in order:
//
//   - an invalid slot (a pad) writes -1 and changes nothing;
//   - each thread walks its nodes in ascending order: fits = every column
//     req[r] <= free[n, r] and cnt_free[n] >= 1, rank = fits ? 1 +
//     used[dom[g, n]] : 0, keeping its first best;
//   - a block argmax on (rank, lowest node index) gives the reference's
//     first maximum (jnp.argmax);
//   - thread 0 commits: the node's free columns and pod budget decrement,
//     its domain is marked used, and the assignment is the node; with no
//     node (rank 0) the assignment is -1 and the group is infeasible — the
//     scan goes on over the remaining slots, as the reference's does.
//
// At the end distinct = the number of used domains (a block sum).
//
// Exactness: the resource columns are GCD-scaled integers; the wrapper
// checks that every magnitude stays below 2^24 (float) or 2^53 (double),
// and a decrement happens only where the request fits, so it stays
// between 0 and the free capacity: every value is exact.  Built with
// --fmad=false and no fast math.
//
// What bounds K7 on an H100: neither bytes nor operations at the path's
// shapes (G 64-256 groups x M 64 slots x N 220-5 000 nodes, R 2): the
// operations are G x M x N x (R + 4), a few hundred million at most, and
// the bytes the free table and the outputs.  The M sequential slots a
// group, each with two block barriers, pace it; G blocks run side by side.

#include <cstdint>
#include <cuda_runtime.h>

// the wrappers' ctypes mirrors (ops/kernels.py GangVerdictArgs and
// GangFeasArgs): every field 8 bytes wide, in this order; outside the
// anonymous namespace so the C entry points that take them keep external
// linkage
struct GangVerdictArgs {
  int64_t K, G, N, D, W;         // W: 32-bit words of a group's domain bitmap
  int64_t gb;                    // groups a block: gb x (2 + W) words of shared memory
  const int32_t* gid;            // [K]
  const int32_t* node;           // [K]
  const int32_t* dom;            // [G,N]
  const int32_t* prior_bound;    // [G]
  const int32_t* min_member;     // [G]
  int32_t* distinct;             // [G]
  int32_t* placed;               // [G]
  uint8_t* feasible;             // [G]
};

struct GangFeasArgs {
  int64_t G, M, N, R, D, smem;   // smem: 1 when a group's state fits shared memory
  const void* req;               // [G,M,R]
  const uint8_t* valid;          // [G,M]
  const void* free;              // [N,R]
  const void* cnt_free;          // [N]
  const int32_t* dom;            // [G,N]
  void* scratch;                 // [G, N*R + N] when !smem
  uint8_t* used_scratch;         // [G, D] when !smem
  uint8_t* feasible;             // [G]
  int32_t* distinct;             // [G]
  int32_t* assignment;           // [G,M]
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VTHREADS = 512;  // K6's block

__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < WARPS; ++w) s += red[w];
  }
  __syncthreads();
  return s;  // valid in thread 0
}

// ------------------------------------------------------------------ K6

__global__ void __launch_bounds__(VTHREADS) verdict_kernel(const __grid_constant__ GangVerdictArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem_raw);  // [gb][2 + W]: placed, failed, bitmap
  const int64_t g0 = (int64_t)blockIdx.x * a.gb;
  const int64_t ng = a.G - g0 < a.gb ? a.G - g0 : a.gb;
  const int64_t stride = 2 + a.W;
  for (int64_t x = threadIdx.x; x < ng * stride; x += blockDim.x) sm[x] = 0;
  __syncthreads();
  for (int64_t k = threadIdx.x; k < a.K; k += blockDim.x) {
    const int64_t g = (int64_t)a.gid[k] - g0;
    if (g < 0 || g >= ng) continue;
    uint32_t* c = sm + g * stride;
    const int32_t n = a.node[k];
    if (n >= 0) {
      atomicAdd(&c[0], 1u);
      int32_t d = a.dom[(g0 + g) * a.N + n];
      if (d < 0) d = 0;
      atomicOr(&c[2 + (d >> 5)], 1u << (d & 31));
    } else {
      atomicAdd(&c[1], 1u);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int64_t g = threadIdx.x >> 5; g < ng; g += blockDim.x >> 5) {
    const uint32_t* c = sm + g * stride;
    int n = 0;
    for (int64_t w = lane; w < a.W; w += 32) n += __popc(c[2 + w]);
    for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
    if (lane == 0) {
      const int64_t gg = g0 + g;
      const int32_t placed = (int32_t)c[0];
      a.distinct[gg] = n;
      a.placed[gg] = placed;
      a.feasible[gg] = (c[1] == 0 && placed + a.prior_bound[gg] >= a.min_member[gg]) ? 1 : 0;
    }
  }
}

// ------------------------------------------------------------------ K7

template <typename T>
__global__ void feasibility_kernel(GangFeasArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int red_rank[WARPS];
  __shared__ int red_idx[WARPS];
  const int64_t g = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t N = a.N, R = a.R, M = a.M, D = a.D;
  T* fr;
  uint8_t* used;
  if (a.smem) {
    fr = reinterpret_cast<T*>(smem_raw);
    used = reinterpret_cast<uint8_t*>(fr + N * R + N);
  } else {
    fr = reinterpret_cast<T*>(a.scratch) + g * (N * R + N);
    used = a.used_scratch + g * D;
  }
  T* cf = fr + N * R;
  const T* free0 = reinterpret_cast<const T*>(a.free);
  const T* cnt0 = reinterpret_cast<const T*>(a.cnt_free);
  for (int64_t i = tid; i < N * R; i += blockDim.x) fr[i] = free0[i];
  for (int64_t i = tid; i < N; i += blockDim.x) cf[i] = cnt0[i];
  for (int64_t i = tid; i < D; i += blockDim.x) used[i] = 0;
  __syncthreads();
  const int32_t* dom = a.dom + g * N;
  const T* req = reinterpret_cast<const T*>(a.req);
  bool ok = true;  // thread 0's
  for (int64_t m = 0; m < M; ++m) {
    if (!a.valid[g * M + m]) {
      // a pad places nothing and leaves the verdict alone (uniform branch)
      if (tid == 0) a.assignment[g * M + m] = -1;
      continue;
    }
    const T* rq = req + (g * M + m) * R;
    int best = 0, best_n = (int)N;
    for (int64_t n = tid; n < N; n += blockDim.x) {
      bool fits = cf[n] >= T(1);
      for (int64_t r = 0; r < R && fits; ++r) fits = rq[r] <= fr[n * R + r];
      if (fits) {
        const int rank = 1 + (used[dom[n]] ? 1 : 0);
        if (rank > best) {
          best = rank;
          best_n = (int)n;
        }
      }
    }
    // block argmax: the highest rank, then the lowest node index
    for (int o = 16; o > 0; o >>= 1) {
      const int r2 = __shfl_down_sync(0xffffffffu, best, o);
      const int n2 = __shfl_down_sync(0xffffffffu, best_n, o);
      if (r2 > best || (r2 == best && n2 < best_n)) {
        best = r2;
        best_n = n2;
      }
    }
    const int lane = tid & 31, warp = tid >> 5;
    if (lane == 0) {
      red_rank[warp] = best;
      red_idx[warp] = best_n;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < WARPS; ++w) {
        if (red_rank[w] > best || (red_rank[w] == best && red_idx[w] < best_n)) {
          best = red_rank[w];
          best_n = red_idx[w];
        }
      }
      if (best > 0) {
        const int64_t p = best_n;
        for (int64_t r = 0; r < R; ++r) fr[p * R + r] = fr[p * R + r] - rq[r];
        cf[p] = cf[p] - T(1);
        used[dom[p]] = 1;
        a.assignment[g * M + m] = (int32_t)p;
      } else {
        a.assignment[g * M + m] = -1;
        ok = false;
      }
    }
    __syncthreads();
  }
  int c = 0;
  for (int64_t i = tid; i < D; i += blockDim.x) c += used[i] ? 1 : 0;
  c = block_sum(c, red_rank);
  if (tid == 0) {
    a.distinct[g] = c;
    a.feasible[g] = ok ? 1 : 0;
  }
}

template <typename T>
int launch_feasibility(const GangFeasArgs* a, void* stream) {
  if (a->G == 0) return (int)cudaSuccess;
  size_t smem = 0;
  if (a->smem) {
    smem = (size_t)(a->N * a->R + a->N) * sizeof(T) + (size_t)a->D;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(feasibility_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  feasibility_kernel<T><<<(unsigned)a->G, THREADS, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kss_gang_verdict(const GangVerdictArgs* a, void* stream) {
  if (a->G == 0) return (int)cudaSuccess;
  const int64_t gb = a->gb < a->G ? a->gb : a->G;
  const size_t smem = (size_t)(gb * (2 + a->W)) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(verdict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  verdict_kernel<<<(unsigned)((a->G + gb - 1) / gb), VTHREADS, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int kss_gang_feasibility_f32(const GangFeasArgs* a, void* stream) {
  return launch_feasibility<float>(a, stream);
}
extern "C" int kss_gang_feasibility_f64(const GangFeasArgs* a, void* stream) {
  return launch_feasibility<double>(a, stream);
}
