// Trace compaction (K3): the scan's [P,N] trace planes → one byte blob
// holding exactly what the annotation writer reads.
//
// Replaces the JAX package's ops/batch.py build_compact_fn.run (:951-1020):
// the visited window from (sample_start, sample_processed, n_true) with
// padded columns excluded, the stable partition of visited and of sampled
// node ids (partition_ids :960), the gather of the first-failure planes
// packed per fail_pack_mode (fail8 / fail16 / separate int8 + int16|int32
// planes), the gather of the score planes at their fetch dtype, and the
// little-endian concatenation in manifest order.  When the scan compacted
// the score rows in its step (in_step_ws0, :993-1002), they arrive [P,ws0]
// in ascending node id: each row is cut to WS and masked by position
// against the pod's feasible count.
//
// What bounds it on an H100: bytes.  It reads the fail planes of the
// visited cells, the sampled mask (or the feasible counts) and the score
// planes of the kept cells, and writes the blob; there is no arithmetic to
// speak of.
//
// Design: one launch, two kinds of block.
//
// - Mapped planes: the fail planes, and the score planes the step
//   compacted.  Their output column j of row i has its source by
//   arithmetic, so nothing is scanned.  With rank = (n - start) mod n_true
//   the visited ids (rank < processed, n < n_true) are at most two runs in
//   ascending id, [0, a) and [b0, b1) (row_window, for any start and
//   processed), so column j reads id j below a and b0 + j - a above it,
//   and columns past the runs take the padding.  An in-step score column
//   reads column j of its row below the feasible count.  A warp takes a
//   tile of 32 x cpl consecutive cells of one row: lane l reads cells l,
//   l + 32, ... (neighbouring lanes on neighbouring ids, so the reads
//   coalesce), packs each into its 512-byte slice of shared memory, and
//   after __syncwarp stores its own cpl consecutive cells as one word of
//   `vec` bytes.  The host picks vec per plane, the widest of 16, 8, 4, 2
//   and 1 bytes that divides both the plane's byte offset and its row's
//   bytes (the blob itself is 16-byte aligned); a cell wider than vec (an
//   int16 or int32 plane at an odd offset) goes out in vec-byte pieces.
//   No block barrier.  Index math is 32-bit within a row; a tile past the
//   row's kept count (most of a sampled round's fail plane) is a fill.
// - Full-plane score planes (every node scored, and the sampled ids when
//   there are no filters): the stable partition of the sampled mask.  One
//   block a row walks it in tiles of 1 024 nodes: each warp ballots its
//   4 x 32 nodes, the warps' counts meet in shared memory at one barrier a
//   tile (double-buffered, so no second barrier), and a kept node's column
//   is the running count plus the warps before it plus the popcount of
//   the lanes below it.  The walk stops once WS columns are kept; the
//   row's tail past its kept count takes the padding.  A lane's kept
//   cells (one a ballot) load four planes at a time before storing them;
//   a kept cell is stored as one word where the plane's offset allows,
//   else in pieces.
//
// Each tile is a short chain of dependent loads (the row's window or
// count, then its cells), so residency hides the latency: the kernel is
// held to 32 registers, 8 blocks an SM (measured on an H100 against 6, 4
// and 1: the fastest at north, cfg4, cfg5-vol and cfg3).
//
// The partition blocks come first in the grid (each is a row's whole
// walk), the mapped tiles after them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 4 * THREADS;  // nodes a partition block walks between barriers
constexpr int LANE_BYTES = 16;     // the widest word a lane stores
constexpr int MAXSP = 16;
constexpr int MAXMP = MAXSP + 2;

// mapped plane kinds (ops/kernels.py _MAP_KINDS)
enum { K_FAIL8 = 0, K_FAIL16 = 1, K_PLUG = 2, K_CODE = 3, K_SCORE = 4 };

}  // namespace

// the wrapper's ctypes mirror (ops/kernels.py CompactArgs): every field 8
// bytes wide, in this order
struct CompactArgs {
  int64_t P, N, n_true, WS, ws0;
  int64_t filters;      // 0: no filters, the blob carries the sids plane
  int64_t off_sids;     // sids plane (no filters)
  int64_t rows;         // partition blocks: P with full-plane score planes or sids, else 0
  int64_t n_sp;         // full-plane score planes
  int64_t n_mp;         // mapped planes
  int64_t map_tiles;    // warp tiles over every mapped plane
  int64_t w_sids;       // bytes a sids store (4, or less at an unaligned offset)
  int64_t sp_off[MAXSP];
  int64_t sp_nb[MAXSP];
  int64_t sp_w[MAXSP];  // bytes a store of a full-plane cell: nb, or less at an unaligned offset
  int64_t mp_kind[MAXMP];
  int64_t mp_src[MAXMP];    // K_SCORE: index into sp_src
  int64_t mp_width[MAXMP];  // cells a row (W or WS)
  int64_t mp_nb[MAXMP];     // bytes a cell
  int64_t mp_vec[MAXMP];    // bytes a store
  int64_t mp_off[MAXMP];
  int64_t mp_tiles[MAXMP];  // warp tiles a row
  int64_t mp_first[MAXMP];  // the plane's first tile (all tiles below 2^31)
  const void* sp_src[MAXSP];  // [P,N] (or [P,ws0]) raw or norm plane in the working dtype
  const int8_t* fail_plug;    // [P,N]
  const int32_t* fail_code;   // [P,N]
  const uint8_t* feasible;    // [P,N]; read by the partition blocks
  const int32_t* sample_start;      // [P]
  const int32_t* sample_processed;  // [P]
  const int32_t* feasible_count;    // [P]; read with ws0
  uint8_t* blob;
};

namespace {

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// the low w bytes of v at p (p w-aligned), w one of 4, 2, 1
__device__ __forceinline__ void put_piece(uint8_t* p, uint32_t v, int w) {
  switch (w) {
    case 4: *reinterpret_cast<uint32_t*>(p) = v; break;
    case 2: *reinterpret_cast<uint16_t*>(p) = (uint16_t)v; break;
    default: *p = (uint8_t)v;
  }
}

// the low nb bytes of v at p, in pieces of w bytes (w divides nb)
__device__ __forceinline__ void put_cell(uint8_t* p, uint32_t v, int nb, int w) {
  if (w == nb) {
    put_piece(p, v, nb);
  } else {
    for (int q = 0; q < nb; q += w) put_piece(p + q, v >> (8 * q), w);
  }
}

// w bytes from s to d, both w-aligned
__device__ __forceinline__ void copy_piece(uint8_t* d, const uint8_t* s, int w) {
  switch (w) {
    case 16: *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s); break;
    case 8: *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s); break;
    case 4: *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s); break;
    case 2: *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s); break;
    default: *d = *s;
  }
}

// w bytes of the repeated byte pattern x at d (w-aligned)
__device__ __forceinline__ void fill_piece(uint8_t* d, uint32_t x, int w) {
  switch (w) {
    case 16: *reinterpret_cast<uint4*>(d) = make_uint4(x, x, x, x); break;
    case 8: *reinterpret_cast<uint2*>(d) = make_uint2(x, x); break;
    default: put_piece(d, x, w);
  }
}

// A row's visited ids in ascending order: [0, a) then [b0, ...), cnt of
// them kept (at most width).  For n in [0, min(n_true, N)): n >= start is
// visited iff n < start + processed; n < start iff n < start + processed -
// n_true (its rank wrapped).
struct Window {
  int a, b0, cnt;
};

__device__ __forceinline__ Window row_window(const CompactArgs& A, int64_t i, int width) {
  const int64_t s = A.sample_start[i], p = A.sample_processed[i], nt = A.n_true;
  const int64_t ntc = nt < A.N ? nt : A.N;
  const int64_t a = clamp64(s < s + p - nt ? s : s + p - nt, 0, ntc);
  const int64_t b0 = clamp64(s, 0, ntc);
  const int64_t kept = a + (clamp64(s + p, b0, ntc) - b0);
  return Window{(int)a, (int)b0, (int)(kept < width ? kept : width)};
}

// The cells lane l reads for a warp tile of a mapped plane: columns col0 +
// 32 r + l for r < cpl (below `valid`: the kept count, or the feasible
// count of a score row), each as its low bytes.  Fully unrolled and
// predicated, so every load of the tile is in flight at once.
template <int KIND, typename T>
__device__ __forceinline__ void load_cells(const CompactArgs& A, int src, int64_t i, int col0, int cpl,
                                           const Window& w, int valid, uint32_t (&v)[LANE_BYTES]) {
  const int lane = threadIdx.x & 31;
  const int8_t* prow = A.fail_plug + i * A.N;
  const int32_t* crow = A.fail_code + i * A.N;
  const T* srow = reinterpret_cast<const T*>(A.sp_src[src]) + i * A.ws0;
#pragma unroll
  for (int r = 0; r < LANE_BYTES; ++r) {
    const int j = col0 + r * 32 + lane;
    uint32_t x = KIND == K_PLUG ? 0xffffffffu : 0u;  // the padding: plug -1, code 0
    if (r < cpl && j < valid) {
      if (KIND == K_SCORE) {
        x = (uint32_t)(int64_t)__ldg(srow + j);
      } else {
        const int id = j < w.a ? j : w.b0 + (j - w.a);
        const int plug = KIND != K_CODE ? (int)__ldg(prow + id) : -1;
        const int code = KIND != K_PLUG ? __ldg(crow + id) : 0;
        x = KIND == K_FAIL8    ? (uint32_t)(((plug + 1) << 4) | code)
            : KIND == K_FAIL16 ? (uint32_t)(((plug + 1) << 8) | code)
            : KIND == K_PLUG   ? (uint32_t)plug
                               : (uint32_t)code;
      }
    }
    v[r] = x;
  }
}

// warp tile t of the mapped planes; stage is the warp's slice
template <typename T>
__device__ __forceinline__ void map_tile(const CompactArgs& A, uint32_t t, uint8_t* stage) {
  int p = 0;
  while (p + 1 < A.n_mp && t >= (uint32_t)A.mp_first[p + 1]) ++p;
  const uint32_t local = t - (uint32_t)A.mp_first[p];
  const uint32_t tiles = (uint32_t)A.mp_tiles[p];
  const uint32_t i = local / tiles;
  const int kind = (int)A.mp_kind[p], nb = (int)A.mp_nb[p], vec = (int)A.mp_vec[p];
  const int width = (int)A.mp_width[p];
  const int cpl = vec >= nb ? vec / nb : 1;  // cells a lane
  const int lb = cpl * nb;                   // bytes a lane: max(vec, nb)
  const int col0 = (int)(local - i * tiles) * 32 * cpl;
  const int lane = threadIdx.x & 31;
  const int j0 = col0 + lane * cpl;
  uint8_t* d = A.blob + A.mp_off[p] + ((int64_t)i * width + j0) * nb;
  Window w{0, 0, 0};
  int valid;
  if (kind == K_SCORE) {
    valid = min(A.feasible_count[i], width);
  } else {
    w = row_window(A, i, width);
    valid = w.cnt;
  }
  if (col0 >= valid) {  // a tile of padding only
    const uint32_t pad = kind == K_PLUG ? 0xffffffffu : 0u;
    if (j0 < width) {
      for (int q = 0; q < lb; q += vec) fill_piece(d + q, pad, vec);
    }
    return;
  }
  uint32_t v[LANE_BYTES];
  const int src = (int)A.mp_src[p];
  switch (kind) {
    case K_FAIL8: load_cells<K_FAIL8, T>(A, src, i, col0, cpl, w, valid, v); break;
    case K_FAIL16: load_cells<K_FAIL16, T>(A, src, i, col0, cpl, w, valid, v); break;
    case K_PLUG: load_cells<K_PLUG, T>(A, src, i, col0, cpl, w, valid, v); break;
    case K_CODE: load_cells<K_CODE, T>(A, src, i, col0, cpl, w, valid, v); break;
    default: load_cells<K_SCORE, T>(A, src, i, col0, cpl, w, valid, v);
  }
#pragma unroll
  for (int r = 0; r < LANE_BYTES; ++r) {
    const int c = r * 32 + lane;
    if (r < cpl && col0 + c < width) put_piece(stage + c * nb, v[r], nb);
  }
  __syncwarp();
  if (j0 < width) {
    for (int q = 0; q < lb; q += vec) copy_piece(d + q, stage + lane * lb + q, vec);
  }
}

__device__ __forceinline__ void put_pad(const CompactArgs& A, int64_t i, int col) {
  const int64_t cell = i * A.WS + col;
  if (!A.filters) put_cell(A.blob + A.off_sids + 4 * cell, 0xffffffffu, 4, (int)A.w_sids);
  for (int k = 0; k < A.n_sp; ++k) {
    const int nb = (int)A.sp_nb[k];
    put_cell(A.blob + A.sp_off[k] + nb * cell, 0u, nb, (int)A.sp_w[k]);
  }
}

// row i's stable partition of the sampled mask into the full-plane planes
template <typename T>
__device__ __forceinline__ void partition_row(const CompactArgs& A, int64_t i) {
  __shared__ int tot[2][WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int N = (int)A.N, WS = (int)A.WS;
  const uint32_t below = (1u << lane) - 1u;
  const uint8_t* frow = A.feasible + i * A.N;
  int run = 0;  // kept so far: the same in every thread
  int buf = 0;
  for (int base = 0; base < N && run < WS; base += TILE) {
    const int n0 = base + warp * 128 + lane;
    uint32_t m[4];
    int wc = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = n0 + 32 * s;
      m[s] = __ballot_sync(0xffffffffu, n < N && __ldg(frow + n));
      wc += __popc(m[s]);
    }
    if (lane == 0) tot[buf][warp] = wc;
    __syncthreads();
    int pos = run, tile = 0;
    for (int q = 0; q < WARPS; ++q) {
      const int x = tot[buf][q];
      tile += x;
      if (q < warp) pos += x;
    }
    // this lane's kept nodes (one a ballot at most) and their columns
    int col[4];
    bool keep[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      col[s] = pos + __popc(m[s] & below);
      keep[s] = ((m[s] >> lane) & 1u) && col[s] < WS;
      pos += __popc(m[s]);
    }
    run += tile;
    buf ^= 1;
    if (!__any_sync(0xffffffffu, keep[0] || keep[1] || keep[2] || keep[3])) continue;
    const int64_t cell0 = i * A.WS;
    if (!A.filters) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (keep[s]) put_cell(A.blob + A.off_sids + 4 * (cell0 + col[s]), (uint32_t)(n0 + 32 * s), 4, (int)A.w_sids);
      }
    }
    // four planes at a time: their loads for the lane's kept nodes in
    // flight together, then their stores
    for (int k0 = 0; k0 < A.n_sp; k0 += 4) {
      uint32_t v[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const T* srow = k0 + kk < A.n_sp ? reinterpret_cast<const T*>(A.sp_src[k0 + kk]) + i * A.N : nullptr;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          v[kk][s] = (srow != nullptr && keep[s]) ? (uint32_t)(int64_t)__ldg(srow + n0 + 32 * s) : 0u;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (k0 + kk < A.n_sp) {
          const int nb = (int)A.sp_nb[k0 + kk], wk = (int)A.sp_w[k0 + kk];
          uint8_t* drow = A.blob + A.sp_off[k0 + kk] + nb * cell0;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            if (keep[s]) put_cell(drow + nb * col[s], v[kk][s], nb, wk);
          }
        }
      }
    }
  }
  for (int j = (run < WS ? run : WS) + threadIdx.x; j < WS; j += blockDim.x) put_pad(A, i, j);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 8) compact_kernel(const __grid_constant__ CompactArgs a) {
  __shared__ __align__(16) uint8_t stage[WARPS][32 * LANE_BYTES];
  if ((int64_t)blockIdx.x < a.rows) {
    partition_row<T>(a, blockIdx.x);
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int64_t t = ((int64_t)blockIdx.x - a.rows) * WARPS + warp;
  if (t < a.map_tiles) map_tile<T>(a, (uint32_t)t, stage[warp]);
}

template <typename T>
int launch(const CompactArgs* a, void* stream) {
  const int64_t blocks = a->rows + (a->map_tiles + WARPS - 1) / WARPS;
  if (blocks == 0) return (int)cudaSuccess;
  compact_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kss_compact_f32(const CompactArgs* a, void* stream) { return launch<float>(a, stream); }
extern "C" int kss_compact_f64(const CompactArgs* a, void* stream) { return launch<double>(a, stream); }
