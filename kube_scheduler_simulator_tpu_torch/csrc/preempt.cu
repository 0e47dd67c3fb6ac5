// The batched victim search (K5): DefaultPreemption's selectVictimsOnNode
// for every (unschedulable pod u, node n) lane.
//
// Replaces the JAX package's preemption/kernel.py build_preempt_fn (:34),
// a jitted vmap(U) x vmap(N) whose per-lane body runs a fori_loop greedy
// reprieve over the V victim slots.  Per lane, in the reference's order of
// operations (the plain version is preemption/kernel.py preempt_plain):
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
// megabytes and a few hundred operations a lane.  The lanes' loads and
// their serial loops pace it.  The design (its redesign for Hopper):
//
//   - a block takes a tile of up to 32 nodes (fewer where the tables of 32
//     would not fit its shared memory) and every preemptor: thread (y, x)
//     runs the lanes (u, n0 + x) for u = y, y + 16, ...; a warp is up to 32
//     neighbouring nodes of one preemptor, so its reads of ucand and its
//     writes of the masks coalesce;
//   - the tile's node tables (alloc, base + extra usage and counts,
//     max_pods, the V slots' requests, priorities, valid flags and PDB
//     matches) are copied into shared memory once, with 16-byte loads
//     where the rows allow, and serve every preemptor of the block;
//   - the same-window successes are bucketed by node once a block (a
//     counting sort of snode over the tile: the counts in shared memory,
//     the list in the block's slice of an S-long global scratch, which
//     starts at the count of successes on lower nodes), so a lane walks
//     only its own node's successes and tests smask for those alone, not
//     all S of them; any S fits, and a lane meets few (~S / N), so the
//     list's home does not set the time;
//   - a lane keeps its lower, viol and victim slots as bits (in registers
//     up to 32 slots) and its per-column sums in registers (up to 4
//     columns), and writes its V victim and viol bytes as 4-byte words
//     where V allows;
//   - cand, victims and viol are views of one buffer (ops/kernels.preempt),
//     so the dispatch fetches them in one copy.

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
  int32_t* slist;          // [S] scratch: the successes bucketed by node
};

namespace {

constexpr int TILE = 32;                // nodes a block, at most
constexpr int ROWS = 16;                // preemptor rows a block
constexpr int THREADS = TILE * ROWS;
constexpr int MAXR = 16;                // resource columns of a lane's arrays
constexpr int REGR = 4;                 // at most this many, the arrays stay in registers
constexpr int MAXV = 1024;              // victim slots a lane's bits hold
constexpr int64_t VM_SMEM = 64 * 1024;  // the tile's PDB matches in shared memory up to this
constexpr int64_t SMEM_MAX = 200 * 1024;  // of the 227 KB a block may take

// byte offsets of the tile's tables in dynamic shared memory (16-aligned)
struct Layout {
  int64_t alloc, use, cnt, maxp, vreq, vprio, bstart, bcur, allowed, vvalid, vmatch, total;
  bool vm_smem;
};

__host__ __device__ inline int64_t up16(int64_t x) { return (x + 15) & ~int64_t(15); }

__host__ __device__ inline Layout layout(const PreemptArgs& a, int64_t tsz, int64_t nt) {
  Layout l;
  const int64_t V = a.V, R = a.R;
  l.vm_smem = nt * V * a.PDB <= VM_SMEM;
  int64_t o = 0;
  l.alloc = o;
  o = up16(o + nt * R * tsz);
  l.use = o;
  o = up16(o + nt * R * tsz);
  l.cnt = o;
  o = up16(o + nt * tsz);
  l.maxp = o;
  o = up16(o + nt * tsz);
  l.vreq = o;
  o = up16(o + nt * V * R * tsz);
  l.vprio = o;
  o = up16(o + nt * V * 8);
  l.bstart = o;
  o = up16(o + (nt + 1) * 4);
  l.bcur = o;
  o = up16(o + (nt + 1) * 4);  // and the successes on lower nodes
  l.allowed = o;
  o = up16(o + (l.vm_smem ? a.PDB * 4 : 0));
  l.vvalid = o;
  o = up16(o + nt * V);
  l.vmatch = o;
  o = up16(o + (l.vm_smem ? nt * V * a.PDB : 0));
  l.total = o;
  return l;
}

// `bytes` from global to shared memory by the block: 16-byte words where
// both ends and the length allow, else 4-byte words, else bytes
__device__ void tile_copy(void* dst, const void* src, int64_t bytes) {
  const uintptr_t m = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)bytes;
  if ((m & 15) == 0) {
    for (int64_t j = threadIdx.x; j < bytes / 16; j += blockDim.x) ((uint4*)dst)[j] = ((const uint4*)src)[j];
  } else if ((m & 3) == 0) {
    for (int64_t j = threadIdx.x; j < bytes / 4; j += blockDim.x) ((uint32_t*)dst)[j] = ((const uint32_t*)src)[j];
  } else {
    for (int64_t j = threadIdx.x; j < bytes; j += blockDim.x) ((uint8_t*)dst)[j] = ((const uint8_t*)src)[j];
  }
}

template <int RB, typename T>
__device__ __forceinline__ bool fits_all(const T (&want)[RB], const T (&free0)[RB], const T* sub, int64_t R) {
  // every column u wants fits (a want <= 0 column is skipped, as the
  // oracle's Fit loop skips it)
  bool ok = true;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r < R) {
      const T avail = sub ? free0[r] - sub[r] : free0[r];
      ok = ok && ((want[r] <= avail) || (want[r] <= T(0)));
    }
  }
  return ok;
}

// a lane's V slot bits as bytes at dst: 4-byte words when V and dst allow
template <int W>
__device__ __forceinline__ void put_bits(uint8_t* dst, const uint32_t (&bits)[W], int64_t V) {
  if ((V & 3) == 0 && ((uintptr_t)dst & 3) == 0) {
    for (int64_t s = 0; s < V; s += 4) {
      const uint32_t b = bits[W == 1 ? 0 : s >> 5] >> (s & 31);
      *(uint32_t*)(dst + s) = (b & 1u) | ((b >> 1) & 1u) << 8 | ((b >> 2) & 1u) << 16 | ((b >> 3) & 1u) << 24;
    }
  } else {
    for (int64_t s = 0; s < V; ++s) dst[s] = (uint8_t)((bits[W == 1 ? 0 : s >> 5] >> (s & 31)) & 1u);
  }
}

// W: 32-bit words of a lane's slot bits (1 keeps them in registers, V <= 32);
// RB: the length of a lane's per-column arrays (REGR keeps them in
// registers, R <= 4; MAXR past it)
template <typename T, int W, int RB>
__global__ void __launch_bounds__(THREADS) preempt_kernel(PreemptArgs a, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(a, sizeof(T), tile);
  const int64_t V = a.V, R = a.R, S = a.S, PDB = a.PDB;
  const int64_t n0 = (int64_t)blockIdx.x * tile;
  const int nt = (int)(a.N - n0 < tile ? a.N - n0 : tile);
  const int tid = threadIdx.x;
  T* alloc = (T*)(smem + l.alloc);
  T* use = (T*)(smem + l.use);
  T* cnt0 = (T*)(smem + l.cnt);
  T* maxp = (T*)(smem + l.maxp);
  T* vreq = (T*)(smem + l.vreq);
  int64_t* vprio = (int64_t*)(smem + l.vprio);
  int* bstart = (int*)(smem + l.bstart);
  int* bcur = (int*)(smem + l.bcur);
  int* below = bcur + tile;
  uint8_t* vvalid = smem + l.vvalid;
  const uint8_t* vmatch = l.vm_smem ? smem + l.vmatch : a.vmatch + n0 * V * PDB;
  const int32_t* allowed = l.vm_smem ? (const int32_t*)(smem + l.allowed) : a.allowed;

  // the tile's tables, once a block
  tile_copy(alloc, (const T*)a.alloc + n0 * R, nt * R * sizeof(T));
  tile_copy(maxp, (const T*)a.max_pods + n0, nt * sizeof(T));
  tile_copy(vreq, (const T*)a.vreq + n0 * V * R, nt * V * R * sizeof(T));
  tile_copy(vprio, a.vprio + n0 * V, nt * V * 8);
  tile_copy(vvalid, a.vvalid + n0 * V, nt * V);
  if (l.vm_smem) {
    tile_copy(smem + l.vmatch, a.vmatch + n0 * V * PDB, nt * V * PDB);
    tile_copy(smem + l.allowed, a.allowed, PDB * 4);
  }
  for (int64_t j = tid; j < nt * R; j += THREADS) {
    use[j] = ((const T*)a.base_req)[n0 * R + j] + ((const T*)a.extra_req)[n0 * R + j];
  }
  for (int j = tid; j < nt; j += THREADS) cnt0[j] = ((const T*)a.base_cnt)[n0 + j] + ((const T*)a.extra_cnt)[n0 + j];
  // the same-window successes on the tile's nodes, bucketed by node: counts
  // and the successes on lower nodes (where the block's slice of slist
  // starts), their exclusive scan (one warp: at most 32 nodes), then the
  // lists; the slices of the blocks tile [0, S) without overlap
  if (tid <= nt) bstart[tid] = 0;
  if (tid == 0) *below = 0;
  __syncthreads();
  int lower_nodes = 0;
  for (int64_t s = tid; s < S; s += THREADS) {
    const int64_t k = a.snode[s] - n0;
    if (k < 0) {
      ++lower_nodes;
    } else if (k < nt) {
      atomicAdd(&bstart[k], 1);
    }
  }
  for (int o = 16; o > 0; o >>= 1) lower_nodes += __shfl_xor_sync(0xffffffffu, lower_nodes, o);
  if ((tid & 31) == 0 && lower_nodes) atomicAdd(below, lower_nodes);
  __syncthreads();
  if (tid < 32) {
    const int c = tid < nt ? bstart[tid] : 0;
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += y;
    }
    if (tid < nt) {
      bstart[tid] = *below + incl - c;
      bcur[tid] = *below + incl - c;
    }
    if (tid == 31) bstart[nt] = *below + incl;
  }
  __syncthreads();
  for (int64_t s = tid; s < S; s += THREADS) {
    const int64_t k = a.snode[s] - n0;
    if (k >= 0 && k < nt) a.slist[atomicAdd(&bcur[k], 1)] = (int)s;
  }
  __syncthreads();  // the block's writes of slist are visible to it after this

  const int x = tid % TILE;
  if (x >= nt) return;
  const int64_t n = n0 + x;
  const T* nvreq = vreq + (int64_t)x * V * R;
  const int64_t* nprio = vprio + (int64_t)x * V;
  const uint8_t* nvalid = vvalid + (int64_t)x * V;
  const uint8_t* nmatch = vmatch + (int64_t)x * V * PDB;
  const T maxp_n = maxp[x];
  for (int64_t u = tid / TILE; u < a.U; u += ROWS) {
    const int64_t lane = u * a.N + n;
    const T* ureq = (const T*)a.ureq + u * R;
    const int64_t prio = a.uprio[u];
    T want[RB], free0[RB], readd[RB], row[RB], usage[RB];
    uint32_t low[W], vio[W], vic[W];
    for (int w = 0; w < W; ++w) low[w] = vio[w] = vic[w] = 0u;
    // 1. lower slots, their count and freed requests
    T n_lower = T(0);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      want[r] = r < R ? ureq[r] : T(0);
      free0[r] = T(0);  // freed, until step 2
    }
    for (int64_t s = 0; s < V; ++s) {
      if (nvalid[s] && nprio[s] < prio) {
        low[W == 1 ? 0 : s >> 5] |= 1u << (s & 31);
        n_lower += T(1);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < R) free0[r] += nvreq[s * R + r];
        }
      }
    }
    // 2. usage with the same-window successes on this node, free capacity,
    //    fit with every lower pod removed
    T cnt = cnt0[x];
#pragma unroll
    for (int r = 0; r < RB; ++r) usage[r] = r < R ? use[x * R + r] : T(0);
    const uint8_t* smask = a.smask + u * S;
    for (int p = bstart[x]; p < bstart[x + 1]; ++p) {
      const int64_t s = a.slist[p];
      if (smask[s]) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < R) usage[r] += ((const T*)a.sreq)[s * R + r];
        }
        cnt += T(1);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) free0[r] = alloc[x * R + r] - (usage[r] - free0[r]);
    }
    const bool cand0 = a.ucand[lane] && fits_all(want, free0, (const T*)nullptr, R) &&
                       (cnt - n_lower + T(1) <= maxp_n) && (n_lower >= T(1));

    // 3. PDB violations by budget rank, in slot order
    for (int64_t k = 0; k < PDB; ++k) {
      const int32_t budget = allowed[k];
      int32_t running = 0;
      for (int64_t s = 0; s < V; ++s) {
        if ((low[W == 1 ? 0 : s >> 5] >> (s & 31) & 1u) && nmatch[s * PDB + k]) {
          running += 1;
          if (running > budget) vio[W == 1 ? 0 : s >> 5] |= 1u << (s & 31);
        }
      }
    }

    // 4. greedy reprieve: violating slots first, then the others, each in
    //    slot order
#pragma unroll
    for (int r = 0; r < RB; ++r) readd[r] = T(0);
    T readd_cnt = T(0);
    bool any = false;
    for (int pass = 0; pass < 2; ++pass) {
      for (int64_t s = 0; s < V; ++s) {
        const int w = W == 1 ? 0 : (int)(s >> 5);
        const uint32_t bit = 1u << (s & 31);
        if (((vio[w] & bit) != 0) != (pass == 0) || !(low[w] & bit)) continue;
#pragma unroll
        for (int r = 0; r < RB; ++r) row[r] = r < R ? readd[r] + nvreq[s * R + r] : T(0);
        const bool ok = fits_all(want, free0, row, R) && (cnt - n_lower + readd_cnt + T(2) <= maxp_n);
        if (ok) {
#pragma unroll
          for (int r = 0; r < RB; ++r) readd[r] = row[r];
          readd_cnt += T(1);
        } else {
          vic[w] |= bit;
        }
        any = any || !ok;
      }
    }
    const bool cand = cand0 && any;
    a.cand[lane] = cand ? 1 : 0;
    if (!cand) {
      for (int w = 0; w < W; ++w) vic[w] = 0u;
    }
    put_bits(a.victims + lane * V, vic, V);
    put_bits(a.viol + lane * V, vio, V);
  }
}

template <typename T, int W, int RB>
cudaError_t launch_w(const PreemptArgs* a, int tile, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(preempt_kernel<T, W, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (a->N + tile - 1) / tile;
  preempt_kernel<T, W, RB><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(*a, tile);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_r(const PreemptArgs* a, int tile, size_t smem, void* stream) {
  return a->R <= REGR ? launch_w<T, W, REGR>(a, tile, smem, stream) : launch_w<T, W, MAXR>(a, tile, smem, stream);
}

template <typename T>
int launch(const PreemptArgs* a, void* stream) {
  if (a->R > MAXR || a->V > MAXV) return (int)cudaErrorInvalidValue;
  // the widest tile whose tables fit
  int tile = TILE;
  while (tile > 0 && layout(*a, sizeof(T), tile).total > SMEM_MAX) --tile;
  if (tile == 0) return (int)cudaErrorInvalidValue;
  if (a->U * a->N == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)layout(*a, sizeof(T), tile).total;
  return (int)(a->V <= 32 ? launch_r<T, 1>(a, tile, smem, stream) : launch_r<T, MAXV / 32>(a, tile, smem, stream));
}

}  // namespace

extern "C" int kss_preempt_f32(const PreemptArgs* a, void* stream) { return launch<float>(a, stream); }
extern "C" int kss_preempt_f64(const PreemptArgs* a, void* stream) { return launch<double>(a, stream); }
