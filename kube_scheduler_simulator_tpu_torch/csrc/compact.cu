// Trace compaction: the scan's [P,N] trace planes → one byte blob holding
// exactly what the annotation writer reads.
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
// What bounds it on an H100: bytes.  It reads the fail planes and the
// sampled mask of every [P,N] cell and the score planes of the sampled
// cells, and writes a blob a fraction of that size; there is no arithmetic
// to speak of.
//
// Design: one block per pod row.  The block walks the row in tiles of
// blockDim nodes (neighbouring threads on neighbouring nodes, so the reads
// coalesce); a running block prefix sum over the visited mask and one over
// the sampled mask give each kept node its output column, so the partition
// is stable and needs no sort; a second loop fills the row's tail past the
// kept count with the padding values.  Bytes are stored one at a time at the
// offsets the wrapper computed from the manifest, so no plane needs any
// alignment.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXSP = 16;

enum { DT_INT8 = 0, DT_INT16 = 1, DT_INT32 = 2 };

}  // namespace

struct CompactArgs {
  int64_t P, N, W, WS, n_true;
  int64_t mode;         // fail_pack_mode 0..3; -1 = no filters (sids plane)
  int64_t off_fail;     // fail8 / fail / fail_plug plane
  int64_t off_code;     // fail_code plane (modes 2, 3)
  int64_t off_sids;     // sids plane (no filters)
  int64_t n_sp;         // score planes
  int64_t ws0;          // width of in-step compacted score planes; 0 = [P,N] planes
  int64_t sp_off[MAXSP];
  int64_t sp_dt[MAXSP];
  const void* sp_src[MAXSP];  // [P,N] (or [P,ws0]) raw or norm plane in the working dtype
  const int8_t* fail_plug;    // [P,N]
  const int32_t* fail_code;   // [P,N]
  const uint8_t* feasible;    // [P,N]; unread with ws0
  const int32_t* sample_start;      // [P]
  const int32_t* sample_processed;  // [P]
  const int32_t* feasible_count;    // [P]; read with ws0
  uint8_t* blob;
};

namespace {

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

__device__ __forceinline__ void put(uint8_t* p, int64_t v, int bytes) {
  for (int k = 0; k < bytes; ++k) p[k] = (uint8_t)((uint64_t)v >> (8 * k));
}

__device__ __forceinline__ int dt_bytes(int64_t dt) { return dt == DT_INT8 ? 1 : dt == DT_INT16 ? 2 : 4; }

// One fail cell (plug, code) at column j of row i, packed per mode.
__device__ __forceinline__ void put_fail(const CompactArgs& a, int64_t i, int64_t j, int plug, int code) {
  const int64_t cell = i * a.W + j;
  if (a.mode == 0) {
    put(a.blob + a.off_fail + cell, ((plug + 1) << 4) | code, 1);
  } else if (a.mode == 1) {
    put(a.blob + a.off_fail + 2 * cell, ((plug + 1) << 8) | code, 2);
  } else {
    put(a.blob + a.off_fail + cell, plug, 1);
    const int cb = a.mode == 2 ? 2 : 4;
    put(a.blob + a.off_code + cb * cell, code, cb);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) compact_kernel(const CompactArgs a) {
  const int64_t i = blockIdx.x;
  const int64_t N = a.N;
  const int start = a.sample_start[i];
  const int proc = a.sample_processed[i];
  const int nt = (int)a.n_true;
  const bool filters = a.mode >= 0;
  const bool in_step = a.ws0 > 0;
  int run = 0, frun = 0;
  for (int64_t base = 0; base < N; base += blockDim.x) {
    const int64_t n = base + threadIdx.x;
    int vis = 0, f = 0;
    if (n < N) {
      const int d = (int)n - start;
      const int rank = d >= 0 ? d : d + nt;
      vis = (rank < proc && n < nt) ? 1 : 0;
      f = !in_step && a.feasible[i * N + n] ? 1 : 0;
    }
    int vt, ft;
    const int pos = run + block_scan(vis, &vt) - 1;
    const int fpos = frun + block_scan(f, &ft) - 1;
    run += vt;
    frun += ft;
    if (filters && vis && pos < a.W) put_fail(a, i, pos, a.fail_plug[i * N + n], a.fail_code[i * N + n]);
    if (f && fpos < a.WS) {
      const int64_t cell = i * a.WS + fpos;
      if (!filters) put(a.blob + a.off_sids + 4 * cell, n, 4);
      for (int k = 0; k < a.n_sp; ++k) {
        const int nb = dt_bytes(a.sp_dt[k]);
        put(a.blob + a.sp_off[k] + nb * cell, (int64_t)((const T*)a.sp_src[k])[i * N + n], nb);
      }
    }
  }
  // the row's tail past the kept count carries the padding values
  if (filters) {
    for (int64_t j = (run < a.W ? run : a.W) + threadIdx.x; j < a.W; j += blockDim.x) put_fail(a, i, j, -1, 0);
  }
  for (int64_t j = (frun < a.WS ? frun : a.WS) + threadIdx.x; !in_step && j < a.WS; j += blockDim.x) {
    const int64_t cell = i * a.WS + j;
    if (!filters) put(a.blob + a.off_sids + 4 * cell, -1, 4);
    for (int k = 0; k < a.n_sp; ++k) {
      const int nb = dt_bytes(a.sp_dt[k]);
      put(a.blob + a.sp_off[k] + nb * cell, 0, nb);
    }
  }
  // in-step planes: the first WS columns, those below the feasible count
  const int fc = in_step ? a.feasible_count[i] : 0;
  for (int64_t j = threadIdx.x; in_step && j < a.WS; j += blockDim.x) {
    const int64_t cell = i * a.WS + j;
    for (int k = 0; k < a.n_sp; ++k) {
      const int nb = dt_bytes(a.sp_dt[k]);
      put(a.blob + a.sp_off[k] + nb * cell, j < fc ? (int64_t)((const T*)a.sp_src[k])[i * a.ws0 + j] : 0, nb);
    }
  }
}

template <typename T>
int launch(const CompactArgs* a, void* stream) {
  compact_kernel<T><<<(unsigned)a->P, THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kss_compact_f32(const CompactArgs* a, void* stream) { return launch<float>(a, stream); }
extern "C" int kss_compact_f64(const CompactArgs* a, void* stream) { return launch<double>(a, stream); }
