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
// The groups are independent and each starts from the same free capacity;
// inside a group the slots run in order, each an argmax over the N nodes
// and a commit to one of them.  A group is one warp (several groups a
// block, no block barrier) where N fits a warp's registers, else one block
// of TG threads:
//
//   - thread t owns nodes t, t + TG, t + 2 TG, ...: it loads their free
//     columns, pod budget and domain id once, coalesced, and no other
//     thread reads them, so they need no barrier.  In the register
//     variants (feas_regs: NPT nodes a thread and RC resource columns are
//     template parameters, every loop over them unrolled, R padded to RC
//     with zero columns, which always fit) they sit in registers; past
//     those (feas_mem) in shared memory, and past that in the group's
//     slice of a global scratch the wrapper allocates;
//   - a node's domain id carries a "domain already used by the group" bit
//     (bit 31), so a node's rank, 0 (no fit), 1 or 2 (its domain used),
//     needs no table of D flags;
//   - the group's request rows and valid flags are staged in shared memory
//     (mc slots at a time); a pad writes -1 there and is skipped;
//   - per valid slot each thread keeps key = rank << 30 | (2^30 - 1 - n)
//     over its fitting nodes: the largest key is the highest rank, then the
//     lowest node index, jnp.argmax's first maximum.  A warp takes its
//     maximum with one redux.sync.  Several warps write theirs, with the
//     domain of its node, into a shared array double-buffered by parity;
//     one __syncthreads, and every warp reduces those itself: one barrier
//     a slot in a block, none in a warp;
//   - the commit: the winner's owner decrements its copy of the node's
//     columns and pod budget and writes the assignment.  A rank-1 winner
//     opens a domain: every thread marks its own nodes of that domain used,
//     and distinct is the count of rank-1 commits.  A valid slot with no
//     fitting node writes -1 and fails the group, and the scan goes on over
//     the remaining slots, as the reference's does.
//
// The host picks the variant by N, R and the dtype (ops/kernels.py
// FEAS_TABLE, from time_gang.py --variants on the card).
//
// Exactness: the resource columns are GCD-scaled integers; the wrapper
// checks that every magnitude stays below 2^24 (float) or 2^53 (double),
// and a decrement happens only where the request fits, so it stays
// between 0 and the free capacity: every value is exact.  Built with
// --fmad=false and no fast math.
//
// What bounds K7 on an H100: the operations, G x valid slots x N x (R + 4)
// compares and selects at 67 (float) or 34 (double) TFLOP/s, a few
// microseconds at G 256 x M 64 x N 5 000; the bytes (the free table, dom
// [G,N], the outputs) are fewer.  The kernel does not reach it: each slot
// is a dependent chain (compares, redux, barrier, commit), M of them in
// order a group, so a group takes M chains and the G groups run side by
// side.

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
  int64_t G, M, N, R;
  int64_t variant;               // kernels.FEAS_VARIANTS index: the kernel's shape
  int64_t mc;                    // member slots staged in shared memory at a time
  int64_t smem;                  // dynamic shared memory of a block, bytes
  const void* req;               // [G,M,R]
  const uint8_t* valid;          // [G,M]
  const void* free;              // [N,R]
  const void* cnt_free;          // [N]
  const int32_t* dom;            // [G,N]
  void* scratch;                 // [G, state bytes] for feas_mem past shared memory, else null
  uint8_t* feasible;             // [G]
  int32_t* distinct;             // [G]
  int32_t* assignment;           // [G,M]
};

namespace {

constexpr int VTHREADS = 512;  // K6's block

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

constexpr int GPB = 4;                      // groups (warps) a block of the one-warp variants
constexpr uint32_t IDX = 0x3fffffffu;       // a key's low 30 bits: IDX - node
constexpr uint32_t USED = 0x80000000u;      // a node's domain id: its group uses the domain
constexpr uint32_t DOMID = 0x7fffffffu;

__host__ __device__ constexpr size_t up16(size_t n) { return (n + 15) & ~(size_t)15; }

template <int TG>
__device__ __forceinline__ void group_sync() {
  if constexpr (TG == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// The group's largest key.  Keys are unique where nonzero (one a node), so
// the lane holding its warp's maximum is the owner of that key's node; in a
// block it writes the node's domain id beside the warp's key.  s_kd:
// [2][2][W] keys then domain ids by parity ph, flipped a slot, so a warp
// that runs ahead to the next slot writes the other half while the last
// readers finish this one.
template <int TG>
__device__ __forceinline__ uint32_t group_max(uint32_t key, uint32_t kdom, uint32_t* s_kd, int ph) {
  const uint32_t wmax = __reduce_max_sync(0xffffffffu, key);
  if constexpr (TG == 32) {
    return wmax;
  } else {
    constexpr int W = TG / 32;
    uint32_t* s = s_kd + ph * 2 * W;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    if (lane == 0) s[w] = wmax;
    if (key == wmax && key) s[W + w] = kdom;
    __syncthreads();
    return __reduce_max_sync(0xffffffffu, lane < W ? s[lane] : 0u);
  }
}

// The domain id of node ns, the group's winner, from its owner (every
// thread of the group calls it).
template <int TG>
__device__ __forceinline__ uint32_t winner_domain(uint32_t kdom, int ns, const uint32_t* s_kd, int ph) {
  if constexpr (TG == 32) {
    return __shfl_sync(0xffffffffu, kdom, ns & 31);
  } else {
    constexpr int W = TG / 32;
    return s_kd[ph * 2 * W + W + ((ns & (TG - 1)) >> 5)];
  }
}

// Stage slots [c0, c0 + cn) of the group: request rows padded to RC columns
// with zeros, valid flags; a pad's assignment is -1.
template <typename T, int TG>
__device__ __forceinline__ void stage_slots(const T* req, const uint8_t* valid, int32_t* asg, int c0, int cn, int R,
                                            int RC, T* s_req, uint8_t* s_valid, int t) {
  for (int i = t; i < cn * RC; i += TG) {
    const int j = i / RC, r = i - j * RC;
    s_req[i] = r < R ? req[(int64_t)(c0 + j) * R + r] : T(0);
  }
  for (int j = t; j < cn; j += TG) {
    const uint8_t v = valid[c0 + j];
    s_valid[j] = v;
    if (!v) asg[c0 + j] = -1;
  }
}

template <typename T, int RC, int TG, int NPT>
__global__ void __launch_bounds__(TG == 32 ? 32 * GPB : TG) feas_regs(const __grid_constant__ GangFeasArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint32_t s_kd[TG == 32 ? 1 : 4 * (TG / 32)];
  constexpr int GB = TG == 32 ? GPB : 1;  // groups a block
  const int t = TG == 32 ? (int)(threadIdx.x & 31) : (int)threadIdx.x;
  const int slot = TG == 32 ? (int)(threadIdx.x >> 5) : 0;
  const int64_t g = (int64_t)blockIdx.x * GB + slot;
  if (g >= a.G) return;  // whole warps, in the one-warp variants only
  const int N = (int)a.N, R = (int)a.R, M = (int)a.M, mc = (int)a.mc;
  T* s_req = reinterpret_cast<T*>(smem_raw) + (size_t)slot * mc * RC;
  uint8_t* s_valid = smem_raw + (size_t)GB * mc * RC * sizeof(T) + (size_t)slot * mc;

  // the thread's nodes t + k TG, once; past N nothing fits (budget 0)
  const T* free0 = reinterpret_cast<const T*>(a.free);
  const T* cnt0 = reinterpret_cast<const T*>(a.cnt_free);
  const int32_t* dom = a.dom + g * a.N;
  T fr[NPT][RC], cf[NPT];
  uint32_t dm[NPT];
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int n = t + k * TG;
    const bool in = n < N;
#pragma unroll
    for (int r = 0; r < RC; ++r) fr[k][r] = (in && r < R) ? free0[(int64_t)n * R + r] : T(0);
    cf[k] = in ? cnt0[n] : T(0);
    dm[k] = in ? (uint32_t)dom[n] : DOMID;
  }
  const int npt = (N + TG - 1) / TG;
  const T* req = reinterpret_cast<const T*>(a.req) + g * a.M * a.R;
  const uint8_t* valid = a.valid + g * a.M;
  int32_t* asg = a.assignment + g * a.M;
  bool ok = true;
  int distinct = 0, ph = 0;
  for (int c0 = 0; c0 < M; c0 += mc) {
    const int cn = min(mc, M - c0);
    if (c0) group_sync<TG>();  // every thread is done with the last chunk
    stage_slots<T, TG>(req, valid, asg, c0, cn, R, RC, s_req, s_valid, t);
    group_sync<TG>();
    for (int j = 0; j < cn; ++j) {
      const bool v = s_valid[j];
      T q[RC];
#pragma unroll
      for (int r = 0; r < RC; ++r) q[r] = s_req[j * RC + r];
      if (!v) continue;  // uniform across the group
      uint32_t key = 0, kdom = 0;
#pragma unroll
      for (int k = 0; k < NPT; ++k) {
        if (k < npt) {
          bool fits = cf[k] >= T(1);
#pragma unroll
          for (int r = 0; r < RC; ++r) fits &= q[r] <= fr[k][r];
          const uint32_t kk = fits ? ((1u + (dm[k] >> 31)) << 30 | (IDX - (uint32_t)(t + k * TG))) : 0u;
          if (kk > key) {
            key = kk;
            kdom = dm[k] & DOMID;
          }
        }
      }
      const uint32_t best = group_max<TG>(key, kdom, s_kd, ph);
      if (best == 0) {
        ok = false;
        if (t == 0) asg[c0 + j] = -1;
      } else {
        const int ns = (int)(IDX - (best & IDX));
        if ((ns & (TG - 1)) == t) {
          const int ks = ns / TG;
#pragma unroll
          for (int k = 0; k < NPT; ++k) {
            if (k == ks) {
#pragma unroll
              for (int r = 0; r < RC; ++r) fr[k][r] = fr[k][r] - q[r];
              cf[k] = cf[k] - T(1);
            }
          }
          asg[c0 + j] = ns;
        }
        if ((best >> 30) == 1u) {  // a new domain: mark the thread's nodes in it
          const uint32_t bdom = winner_domain<TG>(kdom, ns, s_kd, ph);
          ++distinct;
#pragma unroll
          for (int k = 0; k < NPT; ++k) dm[k] |= dm[k] == bdom ? USED : 0u;
        }
      }
      ph ^= 1;
    }
  }
  if (t == 0) {
    a.feasible[g] = ok ? 1 : 0;
    a.distinct[g] = distinct;
  }
}

// The same scan with the nodes' state in memory: [R][N] free columns and
// [N] budgets (T), then [N] domain ids; in dynamic shared memory after the
// staged slots, or in the group's slice of a.scratch.  Still read and
// written by the owner only.
template <typename T, int TG>
__global__ void __launch_bounds__(TG) feas_mem(const __grid_constant__ GangFeasArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint32_t s_kd[4 * (TG / 32)];
  const int t = threadIdx.x;
  const int64_t g = blockIdx.x;
  const int N = (int)a.N, R = (int)a.R, M = (int)a.M, mc = (int)a.mc;
  T* s_req = reinterpret_cast<T*>(smem_raw);
  uint8_t* s_valid = smem_raw + (size_t)mc * R * sizeof(T);
  const size_t cols = up16((size_t)(R + 1) * N * sizeof(T));
  unsigned char* st = a.scratch ? reinterpret_cast<unsigned char*>(a.scratch) + g * (cols + up16((size_t)N * 4))
                                : smem_raw + up16((size_t)mc * R * sizeof(T) + mc);
  T* fr = reinterpret_cast<T*>(st);
  T* cf = fr + (size_t)R * N;
  uint32_t* dm = reinterpret_cast<uint32_t*>(st + cols);
  const T* free0 = reinterpret_cast<const T*>(a.free);
  const T* cnt0 = reinterpret_cast<const T*>(a.cnt_free);
  const int32_t* dom = a.dom + g * a.N;
  for (int n = t; n < N; n += TG) {
    for (int r = 0; r < R; ++r) fr[(size_t)r * N + n] = free0[(int64_t)n * R + r];
    cf[n] = cnt0[n];
    dm[n] = (uint32_t)dom[n];
  }
  const T* req = reinterpret_cast<const T*>(a.req) + g * a.M * a.R;
  const uint8_t* valid = a.valid + g * a.M;
  int32_t* asg = a.assignment + g * a.M;
  bool ok = true;
  int distinct = 0, ph = 0;
  for (int c0 = 0; c0 < M; c0 += mc) {
    const int cn = min(mc, M - c0);
    if (c0) __syncthreads();
    stage_slots<T, TG>(req, valid, asg, c0, cn, R, R, s_req, s_valid, t);
    __syncthreads();
    for (int j = 0; j < cn; ++j) {
      if (!s_valid[j]) continue;  // uniform across the group
      const T* q = s_req + j * R;
      uint32_t key = 0, kdom = 0;
      for (int n = t; n < N; n += TG) {
        bool fits = cf[n] >= T(1);
        for (int r = 0; r < R; ++r) fits &= q[r] <= fr[(size_t)r * N + n];
        if (fits) {
          const uint32_t d = dm[n];
          const uint32_t kk = (1u + (d >> 31)) << 30 | (IDX - (uint32_t)n);
          if (kk > key) {
            key = kk;
            kdom = d & DOMID;
          }
        }
      }
      const uint32_t best = group_max<TG>(key, kdom, s_kd, ph);
      if (best == 0) {
        ok = false;
        if (t == 0) asg[c0 + j] = -1;
      } else {
        const int ns = (int)(IDX - (best & IDX));
        if ((ns & (TG - 1)) == t) {
          for (int r = 0; r < R; ++r) fr[(size_t)r * N + ns] = fr[(size_t)r * N + ns] - q[r];
          cf[ns] = cf[ns] - T(1);
          asg[c0 + j] = ns;
        }
        if ((best >> 30) == 1u) {
          const uint32_t bdom = winner_domain<TG>(kdom, ns, s_kd, ph);
          ++distinct;
          for (int n = t; n < N; n += TG) {
            if (dm[n] == bdom) dm[n] = bdom | USED;
          }
        }
      }
      ph ^= 1;
    }
  }
  if (t == 0) {
    a.feasible[g] = ok ? 1 : 0;
    a.distinct[g] = distinct;
  }
}

template <typename K>
int start(K kern, unsigned grid, int threads, const GangFeasArgs* a, void* stream) {
  if (a->smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a->smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, (size_t)a->smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

template <typename T, int TG, int NPT>
int regs(const GangFeasArgs* a, void* stream) {
  const unsigned grid = TG == 32 ? (unsigned)((a->G + GPB - 1) / GPB) : (unsigned)a->G;
  const int threads = TG == 32 ? 32 * GPB : TG;
  return a->R <= 2 ? start(feas_regs<T, 2, TG, NPT>, grid, threads, a, stream)
                   : start(feas_regs<T, 4, TG, NPT>, grid, threads, a, stream);
}

// kernels.FEAS_VARIANTS, in order: (threads a group, nodes a thread), 0
// nodes a thread for the state in memory
template <typename T>
int launch_feasibility(const GangFeasArgs* a, void* stream) {
  if (a->G == 0) return (int)cudaSuccess;
  switch (a->variant) {
    case 0: return regs<T, 32, 2>(a, stream);
    case 1: return regs<T, 32, 4>(a, stream);
    case 2: return regs<T, 32, 8>(a, stream);
    case 3: return regs<T, 256, 8>(a, stream);
    case 4: return regs<T, 512, 8>(a, stream);
    case 5: return regs<T, 512, 16>(a, stream);
    case 6: return start(feas_mem<T, 512>, (unsigned)a->G, 512, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
