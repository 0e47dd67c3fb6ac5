// The batch scheduling scan: one launch runs the whole pod loop of a round.
//
// Replaces the JAX package's ops/batch.py build_batch_fn: the pairwise
// feature expansion _expand_features (:1702-1721, here per-pod-row gathers
// from the class matrices, never a [P,N] plane), the per-pod step under
// lax.scan (:1264-1700: filters with first-failure tracking, the rotated
// feasible-node sampling prefix sum, seven scores with their normalization,
// selection by first visit rank or the reservoir draw, the commit) and the
// packed outputs and trace meta of _scan (:1723-1780).  PodTopologySpread
// (:1337-1379, :1508-1562, :1642) and InterPodAffinity (:1380-1414,
// :1563-1576, :1644-1662) read their carries through each node's domain
// (node_domain, gdom) where the reference multiplies by one-hot matrices.
// NodePorts, VolumeRestrictions, the EBS/GCE/Azure disk limits,
// NodeVolumeLimits, VolumeBinding and VolumeZone (:1297-1336, commits
// :1627-1641) read their carries only at the pod's own columns (the per-pod
// lists lower() builds), and the in-step score compaction (:1681-1699)
// writes the score rows at [P, ws0] in ascending node id.
//
// Windowed launches (the JAX run_windowed + slice_pod_window, :1162-1182 and
// :1783-1790): a launch runs pods [offset, offset + P) of a larger problem
// from a given initial carry and writes the whole final carry, so windows
// chain on the card with no host round trip.  The wrapper hands every
// pod-axis row array in at row `offset`; the two arrays that carry pods on
// their second axis (spread_match, term_match) are read with the row
// stride Psrc of the full problem; the rotation start may come from the
// device (start_ptr, the previous window's final_start); the reservoir
// counter base arrives shifted by the offset.  A one-launch round is the
// window at offset 0 over every pod.
//
// What bounds it on an H100: the sequential dependency chain.  Pod i+1's
// filters read the carry pod i committed, so the P steps run one after the
// other, each a handful of passes over N nodes with block-wide scans and
// reductions between them; the per-step latency (barriers, L1/L2 round
// trips of the carry) sets the pace, far above both the bytes it must move
// (the [P,N] trace planes) and its operations.
//
// Design: one thread-block cluster of C = kernels.cluster_width(N, lanes)
// blocks walks a lane's pod chain (Clusters, below): block k of the cluster
// walks rank tiles k, k + C, ... of the visit order (rank r -> node (start
// + r) % n_true, padding columns after), so each pod's passes over the N
// nodes are split C ways.  With the trace on, each block writes the trace
// columns of its own rank tiles for every pod (failure codes, reasons, the
// sampled mask, the raw and normalized score planes); the pod's packed row
// is written once, by the committing block.  A cluster of one block runs
// the same code without DSMEM or cluster barriers.  The earlier design,
// every block running the full pod loop on its own copy of the carry and
// writing the trace rows of pods i with i % gridDim.x == b (MODE_BLOCKS,
// csrc/scan.cu built alone), stays for comparisons only: time_scan.py
// times the two, chip_smoke.py holds them bitwise equal.
//
// Passes per pod: (0) PodTopologySpread's per-domain sums, each constraint's
// minimum over domains and InterPodAffinity's required-affinity total, when
// the pod has constraints or terms; (1) filters, the rotated prefix sum and
// sampling, InterPodAffinity's raw score and its extrema over the sampled
// nodes, and the sampled domains PodTopologySpread's score counts;
// (1b) PodTopologySpread's raw score and its extrema, when the pod has score
// constraints; (2) scores and weighted totals; (3) selection; the commit.
// Domain sums of a key with few domains live in shared memory, the rest in
// global scratch; identity keys (one domain per node, such as the
// hostname) need none: their minimum is a block reduction over nodes.
//
// Carries: spread_counts [SG,N] and ip_sel, ip_own, ip_anti [G,D+1] (column
// D is the reference's sink for a node without the key: never read, but
// committed as the reference does, so the final carry a window hands on
// equals the reference's), one copy a lane in global scratch (one a block
// of the redundant chains).  The volume carries are kept column-major, so
// neighbouring threads read neighbouring nodes: ports_used [PT,N],
// restr_used [VR,N], cloud_used [3,N] in the working dtype, the CSI
// attachment bits [V,N] as bytes (they are 0 or 1), and beside them the
// count of attached ids per (driver, node) [DR,N], which the commit (the
// owner of the node's rank tile) raises by the pod's newly attached ids.
// So NodeVolumeLimits reads the pod's few ids and one count per driver, not
// the reference's whole [N,V] product: exact, since every count is an
// integer.
//
// In-step compaction: the sampled nodes are the first sample_k feasible in
// visit order, which starts at node `start`.  A sampled node's rank among
// the sampled ones in visit order is its running count c - 1; with c_hi the
// number of sampled nodes of id >= start (visited first) and n_s the number
// sampled, its rank in ascending node id is (n_s - c_hi) + c - 1 for
// id >= start and c - 1 - c_hi below.  In a cluster, c is the tiles'
// exclusive scan plus the count within the tile, and c_hi (each block's
// largest c below rank n_true - start) travels in the same DSMEM exchange
// as the k-th feasible rank, so it adds no barrier; the zero columns past
// n_s are written by the blocks in stretches of THREADS.
//
// Lanes (K8, replacing the JAX package's autoscaler/estimator.py:186
// ScaleUpEstimator._estimate_kernel, which runs this scan vmapped over a
// [G,N] node_active mask, one lane a node group): blockIdx.y is the lane.
// The cluster (b, g) runs the whole pod loop of lane g on its lane's copy of
// the carry, read from the shared initial carry (the estimator's template
// rows carry no bound pods), with its own lane's mask row node_active[g]
// (lane stride N), and writes its lane's slices of packed_pod and of every
// final carry (lane strides 5*P, N*R, N*2, N, ...).  Lane launches run with
// the trace off: the trace planes and their meta have no lane stride, and
// launch() refuses them.
//
// Clusters (every launch since the one-lane scan was redesigned for Hopper;
// K9 and K8 first): a launch runs each lane on one thread-block cluster of
// C blocks, grid (C, lanes), cluster dims (C, 1, 1).  C = min(8, node
// tiles, 132 / lanes), and 1 where a lane has at most two tiles, is a
// function of the shape (kernels.cluster_width).  The rotated prefix sum
// stays a plain scan: each block scans its tiles, the tiles' feasible
// counts are exclusive-scanned across the cluster through distributed
// shared memory (DSMEM), and every block then samples its nodes with the
// cluster-wide count.  The other per-pod reductions (the k-th feasible
// rank, c_hi, the score extrema, PodTopologySpread's minima over nodes, the
// selection's best total and rank) are combined through DSMEM slots in
// fixed rank order; min and max are exact in any order.  PodTopologySpread's
// domain sums and sampled-domain flags live once a lane, in rank 0's shared
// memory (DSMEM atomics) or in the lane's global scratch: exact, as below.
// The carries are one copy a lane in global scratch: the block that owns
// the selected node's rank tile commits it, and a cluster barrier
// (release/acquire at cluster scope) orders those global writes before the
// next pod reads them.  Where every carry a pod reads is a per-node one (no
// InterPodAffinity rows, no PodTopologySpread domain sums) and every block
// knows the selection (first tie), the block that owns the node's rank in
// the NEXT pod commits it instead, so that barrier goes: a block then reads
// only carries it wrote itself or that an earlier barrier published.  The
// barriers, not the DSMEM reads, are what a cluster adds to a pod's time
// (PERF.md), so this is three barriers a pod at the tuner's imbalance
// problem (after the tiles' counts, after sampling, after the selection),
// four with InterPodAffinity, one more with PodTopologySpread's domain sums,
// one more for its score extrema, and the reservoir draw two more.  The
// trace meta (each score's min and max, the largest failure code) is kept
// by each block over its nodes and combined once, after the pod loop, in
// rank 0's slots.  A window hands on one carry copy a lane: the next
// window's blocks copy it in, a stretch each.
//
// Term groups: InterPodAffinity's filter and raw score walk the pod's own
// list of matching term groups (ip_match_g, ascending g, built on the host
// from term_match) instead of every group, so a pod that matches one of G
// groups costs one carry read a node, not G; the sum keeps ascending g, so
// it is bitwise the loop over every group.  The commit still adds
// term_match's column to every group row.
//
// Weights: the score weights are a device array read per lane, row
// weights + lane * w_stride in the working dtype.  A one-lane scan, a
// window and K8 pass the profile's row with stride 0; K9 (replacing the
// JAX package's tuning/relax.py:36-60 build_value_fn / build_population_fn,
// jax.vmap of the rollout over a [pop,S] weight matrix) passes the
// population with stride S and one shared node_active (na_stride 0), so
// lane g is the rollout under weights[g].  The profile's weights cast to
// T on the host round as T(double) did in the kernel, so the one-lane
// launches stayed bitwise what they were.
//
// Grad mode (K2g's forward, replacing the autodiff through the JAX
// package's straight-through head, ops/batch.py:1614-1623,
// tuning/relax.py:63-71): one lane, a cluster, trace off.  The weights
// enter only the totals and every score reaches its normalized value
// through floor/trunc/round, so the gradient of an objective of
// final_nonzero is a sum over committed pods i: with s_i = softmax(totals_i
// / tau) over the sampled nodes, c_i[n] = F[n,0] pnz_i0 + F[n,1] pnz_i1 and
// F = d objective / d final_nonzero,
//
//   dw_k = (1 / tau) sum_i sum_n s_i[n] (c_i[n] - sum_m s_i[m] c_i[m]) norm_ik[n].
//
// It is linear in F, and since sum_n s_i[n] = 1 the mean of c_i may move
// onto the scores: with nbar_ik = sum_n s_i[n] norm_ik[n],
//
//   dw_k = (1 / tau) sum_{n,j} F[n,j] M[j,k,n],
//   M[j,k,n] = sum_i pnz_ij s_i[n] (norm_ik[n] - nbar_ik),
//
// exact in math.  M [2,S,N] (float64, global memory) does not depend on F,
// so this launch folds it over the pod chain as it runs the hard rollout,
// and the backward (csrc/tune.cu's contraction) reads it with F: no second
// pass over the chain.  Per pod, each block sums e = exp(z - its max) and
// the S sums of e norm_k over its nodes in one block tree (the max of z
// over its sampled nodes is its best total over tau: IEEE division by tau
// > 0 is monotone); the selection's DSMEM exchange carries them, and warp
// 0 rescales each block's by exp(its max - the cluster's), so the grad
// mode adds no cluster barrier.  Then, for a committed pod, the thread
// that owns node n adds pnz_ij s[n] (norm_k[n] - nbar_k) to M[j,k,n], in
// float64 from the working dtype's s = exp(z - max) / sum e and nbar_k =
// sum e norm_k / sum e; the cluster barriers between pods order these
// writes when a node's owner changes with `start`.  Its sums run in the cluster's order and M sums pods before
// F, where the plain version (ops/batch.grad_plain) sums each pod's terms
// with F first, so the two agree to a stated tolerance, not bitwise; exp is
// the IEEE expf/exp (no fast math).  The launch also writes the hard
// rollout's outputs and final carry, bitwise.
//
// Exactness: built with --fmad=false and without fast math; every formula
// keeps the reference's order of operations, divisions are IEEE divisions,
// quotients go through floor/trunc, rounding is rint (half to even, as
// jnp.round), and the reservoir hash is uint32.  The domain sums use
// atomicAdd, whose order varies; they stay exact because every count is an
// integer-valued float below 2^24 (float32's integer range), so any order
// gives the same sum.  log(tsize + 2) is read from a table the wrapper fills
// with torch.log, which the plain version reads too.

#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAXF = 16;
constexpr int MAXS = 8;
constexpr int MAXFR = 4;
constexpr int MAXSHAPE = 16;
constexpr int MAXC = 8;    // PodTopologySpread constraints per pod, of each kind
constexpr int MAXKU = 16;  // topology keys the constraints and terms use
constexpr int MAXCL = 16;  // blocks of a lane's cluster (above 8: a non-portable size)
constexpr int MAXT = THREADS / 2;  // rank tiles a cluster block owns (N <= THREADS tiles, C >= 2)
enum { MODE_BLOCKS = 0, MODE_GRAD = 1, MODE_CLUSTER = 2, MODE_TRACE = 3 };

enum {
  F_UNSCHED = 0, F_NAME = 1, F_TAINT = 2, F_AFF = 3, F_FIT = 4, F_SPREAD = 5, F_IPA = 6,
  F_PORTS = 7, F_RESTR = 8, F_EBS = 9, F_GCE = 10, F_AZURE = 11, F_CSI = 12, F_VB = 13, F_VZ = 14,
};
enum { S_FIT = 0, S_BAL = 1, S_IMG = 2, S_TAINT = 3, S_AFF = 4, S_SPREAD = 5, S_IPA = 6 };
enum { FIT_LEAST = 0, FIT_MOST = 1, FIT_RTCR = 2 };

}  // namespace

// Every field is 8 bytes wide, so the layout matches the ctypes mirror in
// ops/kernels.py without padding rules.
struct ScanArgs {
  int64_t P, N, R, n_true, sample_k, start0, tb_base, seed_mix;
  int64_t Psrc;  // row stride of spread_match and term_match: the full problem's P
  int64_t trace, reservoir;
  int64_t lanes;  // the grid's y extent: K8's node masks or K9's weight rows
  int64_t na_stride;  // lane stride of node_active: N (K8) or 0 (one mask)
  int64_t w_stride;   // lane stride of weights: S (K9) or 0 (one row)
  int64_t grad;       // K2g's forward: fold the residual M into resid
  int64_t cluster;    // blocks of each lane's thread-block cluster (1 in MODE_BLOCKS)
  int64_t nf, filters[MAXF];
  int64_t ns, scores[MAXS];
  int64_t fit_strategy, n_fit_res, fit_col[MAXFR];
  double fit_w[MAXFR];
  double fit_wsum;
  int64_t n_shape, shape_u[MAXSHAPE], shape_s[MAXSHAPE];
  int64_t T_cols, M_cols, MP_cols, MC_cols;
  int64_t use_spread_f, use_spread_s, use_ipa;
  int64_t KC, KS, KA, KB, KP, KO, KM, SG, G, D;
  int64_t dom_cap;   // domains of the largest interned key a constraint uses
  int64_t dom_smem;  // 1: the domain sums live in dynamic shared memory
  int64_t key_base[MAXKU];  // first domain id of each used key
  int64_t key_size[MAXKU];  // domains of an interned key; 0 = identity key
  int64_t ws0;              // width of the compacted score rows; 0 = [P,N] rows
  int64_t use_ports, use_restr, use_cloud, use_csi;
  int64_t PT, VR, VID, DR, KPT, KVR, KV, VB_cols;
  double cloud_limit[3];    // EBS, GCE PD, Azure disk: cloud_cnt's columns
  double tau;               // K2g's softmax temperature
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
  const uint8_t* node_active;  // [lanes,N]
  const uint8_t* incl_cls;     // [A,M] spread inclusion per (affinity class, label class)
  const int32_t* node_domain;  // [KT,N] global domain id per key, -1 = no label
  const int32_t* spf_key;      // [P,KC] DoNotSchedule constraints: key, -1 = none
  const int32_t* spf_grp;      // [P,KC] selector group
  const int32_t* spf_ku;       // [P,KC] used-key index
  const void* spf_skew;        // [P,KC]
  const void* spf_self;        // [P,KC]
  const int32_t* sps_key;      // [P,KS] ScheduleAnyway constraints
  const int32_t* sps_grp;
  const int32_t* sps_ku;
  const void* sps_skew;
  const void* spread_match;    // [SG,P]
  const int32_t* gdom;         // [G,N] domain id of each term group's key
  const void* term_match;      // [G,P]
  const int32_t* ip_match_g;   // [P,KM] groups whose term selects the pod, ascending, -1 padded
  const int32_t* ip_aff_g;     // [P,KA] required affinity groups, -1 = none
  const int32_t* ip_anti_g;    // [P,KB] required anti-affinity groups
  const int32_t* ip_pref_g;    // [P,KP] preferred groups
  const void* ip_pref_w;       // [P,KP] signed weights
  const int32_t* ip_own_g;     // [P,KO] groups the pod's own terms add to
  const void* ip_own_w;        // [P,KO]
  const uint8_t* ip_self_match;  // [P]
  const int32_t* port_cols;    // [P,KPT] the pod's host-port classes, -1 padded
  const void* port_conflict;   // [PT,PT]
  const int32_t* restr_cols;   // [P,KVR] the pod's conflict volumes
  const void* restr_conflict;  // [VR,VR]
  const void* cloud_cnt;       // [P,3]
  const int32_t* csi_cols;     // [P,KV] the pod's CSI volume ids
  const int32_t* csi_drv;      // [V] driver of each id, -1 none
  const void* csi_seed_used;   // [N,DR] attachments of ids no pending pod mounts
  const void* csi_limit;       // [N,DR]
  const int8_t* vb_cls;        // [VC,M] VolumeBinding code per (volume class, label class)
  const int8_t* vz_cls;        // [VC,M] VolumeZone code
  const int32_t* pod_vol_idx;  // [P]
  const void* log_table;       // [N+1] log(t + 2)
  const void* weights;         // [lanes or 1, S] score weights in the working dtype
  double* resid;               // [2,S,N] K2g's residual M, float64 (grad mode)
  const void* requested0;
  const void* nonzero0;
  const void* pod_count0;
  const void* spread_counts0;  // [SG,N]
  const void* ip_sel0;         // [G,D+1]
  const void* ip_own0;
  const void* ip_anti0;
  const void* ports_used0;     // [N,PT]
  const void* restr_used0;     // [N,VR]
  const void* cloud_used0;     // [N,3]
  const void* csi_attached0;   // [N,V]
  const int32_t* start_ptr;    // [1] the rotation start on the card; null: start0
  void* s_requested;   // [B,N,R] per-block carry (per lane in a cluster)
  void* s_nonzero;     // [B,N,2]
  void* s_pod_count;   // [B,N]
  void* s_spread;      // [B,SG,N]
  void* s_ip_sel;      // [B,G,D+1]
  void* s_ip_own;
  void* s_ip_anti;
  void* s_raw_spread;  // [B,N] PodTopologySpread raw score of the current pod
  void* s_raw_ipa;     // [B,N] InterPodAffinity raw score of the current pod
  void* s_dom;         // [B,(KC+KS)*dom_cap] domain sums, when not in shared memory
  int32_t* s_domflag;  // [B,(KC+KS)*dom_cap] domain flags
  void* s_total;       // [B,N] masked weighted totals of the current pod
  uint8_t* s_flags;    // [B,N] bit 0 feasible, bit 1 sampled, bit 2 has every score key
  int32_t* s_rank;     // [B,N] running feasible count in visit order (in-step compaction;
                       // in a cluster, the count within the node's rank tile)
  void* s_ports;       // [B,PT,N]
  void* s_restr;       // [B,VR,N]
  void* s_cloud;       // [B,3,N]
  uint8_t* s_csi;      // [B,V,N] attachment bits
  void* s_csi_cnt;     // [B,DR,N] attached ids per driver
  void* s_norm;        // [B,S,N] normalized scores of the current pod (grad mode)
  int32_t* packed;     // [lanes,5,P]
  int32_t* final_start;  // [lanes]
  void* final_requested;
  void* final_nonzero;
  void* final_pod_count;
  void* final_ports_used;   // [N,PT]
  void* final_restr_used;   // [N,VR]
  void* final_cloud_used;   // [N,3]
  void* final_csi_att;      // [N,V]
  void* final_spread;       // [SG,N]
  void* final_ip_sel;       // [G,D+1]
  void* final_ip_own;
  void* final_ip_anti;
  int8_t* fail_plug;   // [P,N]
  int32_t* fail_code;  // [P,N]
  uint8_t* feasible;   // [P,N]; not written with ws0
  void* raw[MAXS];     // [P,N] each, [P,ws0] with ws0
  void* norm[MAXS];
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

// The block's sums of v[0..m) (m <= MAXS + 1 <= the block's warps) in one
// tree: each warp's partial sums, then warp k adds sum k's partials; out[k]
// (shared memory) holds sum k for every thread after the call.
template <typename V>
__device__ void block_sums(const V (&v)[MAXS + 1], int m, V* out) {
  __shared__ V sh[32][MAXS + 1];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k <= MAXS; ++k) {
    if (k < m) {
      V x = v[k];
      for (int o = 16; o > 0; o >>= 1) x = x + __shfl_down_sync(0xffffffffu, x, o);
      if (lane == 0) sh[w][k] = x;
    }
  }
  __syncthreads();
  if (w < m) {
    V x = lane < nw ? sh[lane][w] : V(0);
    for (int o = 16; o > 0; o >>= 1) x = x + __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) out[w] = x;
  }
  __syncthreads();
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

namespace cg = cooperative_groups;

// A cluster block's exchange slots, in its shared memory: each block writes
// its own, a cluster barrier publishes them, then warp 0 reads all C of them
// (lane q block q's, at_rank), combines them and leaves the cluster's value
// in the block's own `out` slots for its threads: one remote read a lane,
// not one a thread.
template <typename T>
struct ClusterX {
  T lmin[MAXC];         // pass 0: minima over the block's nodes (identity keys)
  int tile_feas[MAXT];  // pass 1: feasible nodes in each of the block's rank tiles
  int tile_tied[MAXT];  // reservoir: nodes tied at the best total in each tile
  int kth, n_fni, c_hi, best_rank;
  T mx_taint, mx_aff, ip_mn, ip_mx, sp_mn, sp_mx, best;
  T g_part[MAXS + 1];   // grad mode: sum e and sum e norm_k over the block's sampled nodes
  // trace meta: each block's score min/max and largest failure code, in
  // rank 0's copy (written there once, after the pod loop)
  T m_mn[MAXCL][MAXS], m_mx[MAXCL][MAXS];
  int m_code[MAXCL];
  int out_i[3];         // the cluster's values, for this block's threads
  T out_t[MAXC + 4];
};
static_assert(MAXC + 4 >= MAXS + 2, "out_t holds the best total and the grad mode's sums");
static_assert(MAXS + 1 <= THREADS / 32, "block_sums gives each sum a warp");

// warp 0's reduction of the lanes' values (one a cluster block) to lane 0
template <typename V, typename Op>
__device__ __forceinline__ V warp_combine(V v, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// the same shared-memory object in the cluster's block of rank `rank`
template <typename V>
__device__ __forceinline__ V* at_rank(V* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, (unsigned)rank);
}

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
__device__ __forceinline__ float d_rint(float x) { return rintf(x); }
__device__ __forceinline__ double d_rint(double x) { return ::rint(x); }
__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return ::exp(x); }

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

// Does node n have every key of the pod's active score constraints?
__device__ __forceinline__ bool has_all_keys(const ScanArgs& a, const int32_t* sk, int64_t n) {
  for (int k = 0; k < a.KS; ++k) {
    if (sk[k] >= 0 && a.node_domain[(int64_t)sk[k] * a.N + n] < 0) return false;
  }
  return true;
}

// carry[g, domain of node n under group g], 0 when the node lacks the key
template <typename T>
__device__ __forceinline__ T at_node(const ScanArgs& a, const T* carry, int g, int64_t n) {
  const int d = a.gdom[(int64_t)g * a.N + n];
  return d >= 0 ? carry[(int64_t)g * (a.D + 1) + d] : T(0);
}

// dst[c * R + r] = src[r * C + c]: a row-major [R,C] carry into its
// transpose (a volume carry in at a launch's start, out at its end), over
// the source's elements j0, j0 + step, ...: the reads coalesce, the
// scattered stores do not stall, and four loads go out before their stores.
template <typename S, typename D>
__device__ void copy_transposed(const S* src, D* dst, int64_t R, int64_t C, int64_t j0, int64_t step) {
  const int64_t total = R * C;
  for (int64_t j = j0; j < total; j += 4 * step) {
    S v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j + u * step < total) v[u] = src[j + u * step];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t jj = j + u * step;
      if (jj < total) dst[(jj % C) * R + jj / C] = D(v[u]);
    }
  }
}

// TOPO = false compiles PodTopologySpread's and InterPodAffinity's work out
// (a problem without spread constraints or term groups), so that path keeps
// the registers of a kernel without them; VOL = false does the same for the
// host-port, conflict-volume, cloud-disk and CSI carries.  A block takes an
// SM, so the bounds allow one resident block and up to 128 registers a
// thread: capped at 64, the float64 kernel spilled to local memory.
// MODE_CLUSTER compiles the cluster's exchanges in (a lane a cluster of
// gridDim.x blocks) with the trace off, MODE_TRACE the same with the trace
// on, MODE_GRAD the exchanges and K2g's residual, MODE_BLOCKS neither (the
// redundant chains, for comparisons; the trace on or off at run time).  The
// trace's per-score meta arrays cost local memory, so the modes without a
// trace compile them out.
template <typename T, bool TOPO, bool VOL, int MODE>
__global__ void __launch_bounds__(THREADS, 1) scan_kernel(const ScanArgs a) {
  constexpr bool GRAD = MODE == MODE_GRAD;
  constexpr bool CL = MODE != MODE_BLOCKS;
  const bool trace = MODE == MODE_TRACE || (MODE == MODE_BLOCKS && a.trace != 0);
  const int tid = threadIdx.x;
  const int b = blockIdx.x;  // in a cluster: the block's rank in it
  const int B = gridDim.x;
  // a cluster of one block runs the one-block code: no DSMEM, no cluster
  // barrier
  const bool split = CL && B > 1;
  auto csync = [&]() {
    if (split) {
      cluster_sync();
    } else {
      __syncthreads();
    }
  };
  const int64_t P = a.P, N = a.N, R = a.R;
  // the lane, and this block's scratch slot: its own, or its lane's (the
  // blocks of a cluster share one copy of the carries)
  const int64_t lane = blockIdx.y;
  const int64_t sb = CL ? lane : lane * B + b;
  // the rank tiles this block walks (every one, or b, b + C, ...) and its
  // share of the once-a-launch copies (all, or every C-th stretch)
  const int64_t T0 = CL ? (int64_t)b * THREADS : 0, TSTEP = CL ? (int64_t)B * THREADS : THREADS;
  const int64_t i0 = CL ? (int64_t)b * THREADS + tid : tid, istep = CL ? (int64_t)B * THREADS : THREADS;
  __shared__ ClusterX<T> cx;
  __shared__ int tile_off[THREADS];
  const uint8_t* node_act = a.node_active + lane * a.na_stride;
  const T* wrow = (const T*)a.weights + lane * a.w_stride;
  T* snorm = GRAD ? (T*)a.s_norm + sb * a.ns * N : nullptr;
  int32_t* const packed = a.packed + lane * 5 * P;
  const int nt = (int)a.n_true;
  const int K = (int)a.sample_k;
  const T* alloc = (const T*)a.alloc;
  const T* max_pods = (const T*)a.max_pods;
  const T* nz_alloc = (const T*)a.nz_alloc;
  const T* pod_req = (const T*)a.pod_req;
  const T* pod_nonzero = (const T*)a.pod_nonzero;
  T* req = (T*)a.s_requested + sb * N * R;
  T* nzc = (T*)a.s_nonzero + sb * N * 2;
  T* pc = (T*)a.s_pod_count + sb * N;
  T* tot = (T*)a.s_total + sb * N;
  uint8_t* fl = a.s_flags + sb * N;
  const T NEG = T(-1e18);
  const T INF = T(INFINITY);

  // spread_counts is carried whenever the problem has selector groups,
  // as the reference commits it (SG > 0), read only by the spread plugin
  const bool spread_on = TOPO && a.SG > 0;
  const bool ipa = TOPO && a.use_ipa != 0;
  bool ipa_scored = false;
  for (int k = 0; k < a.ns; ++k) ipa_scored = ipa_scored || (ipa && a.scores[k] == S_IPA);
  const int64_t GD = a.G * (a.D + 1);
  T* spc = (T*)a.s_spread + sb * a.SG * N;
  T* isel = (T*)a.s_ip_sel + sb * GD;
  T* iown = (T*)a.s_ip_own + sb * GD;
  T* ianti = (T*)a.s_ip_anti + sb * GD;
  T* spraw = (T*)a.s_raw_spread + sb * N;
  T* ipraw = (T*)a.s_raw_ipa + sb * N;
  const int64_t cap = a.dom_cap;
  const int64_t nslot = a.KC + a.KS;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* dom_sum = a.dom_smem ? (T*)dyn_smem : (T*)a.s_dom + sb * nslot * cap;
  int* dom_flag = a.dom_smem ? (int*)(dyn_smem + nslot * cap * sizeof(T)) : a.s_domflag + sb * nslot * cap;
  const T* log_table = (const T*)a.log_table;
  const bool ports = VOL && a.use_ports, restr = VOL && a.use_restr;
  const bool cloud = VOL && a.use_cloud, csi = VOL && a.use_csi;
  T* sports = ports ? (T*)a.s_ports + sb * a.PT * N : nullptr;
  T* srestr = restr ? (T*)a.s_restr + sb * a.VR * N : nullptr;
  T* scloud = cloud ? (T*)a.s_cloud + sb * 3 * N : nullptr;
  uint8_t* scsi = csi ? a.s_csi + sb * a.VID * N : nullptr;
  T* scnt = csi ? (T*)a.s_csi_cnt + sb * a.DR * N : nullptr;
  const int ws0 = (int)a.ws0;
  int32_t* srank = ws0 > 0 || CL ? a.s_rank + sb * N : nullptr;
  // PodTopologySpread's domain sums and flags: a cluster's live once, in
  // rank 0's shared memory or in the lane's scratch
  const bool dom_used = TOPO && (a.use_spread_f || a.use_spread_s);
  T* const dom_sum0 = dom_sum;
  int* const dom_flag0 = dom_flag;
  if (split && a.dom_smem) {
    dom_sum = at_rank(dom_sum, 0);
    dom_flag = at_rank(dom_flag, 0);
  }
  // A cluster's barrier after the commit: where a block may read a carry
  // another block committed (InterPodAffinity's per-domain rows), rank 0
  // zeroes the domain sums, or only one block knows the selection (the
  // reservoir).  Elsewhere the block that owns the selected node's rank in
  // the next pod commits it, and every carry a block reads before the next
  // barrier is its own nodes'.
  const bool commit_sync = ipa || dom_used || a.reservoir;
  // rank 0 zeroes them for the next pod once every block has read them
  auto zero_domains = [&]() {
    if (CL && b == 0 && dom_used) {
      for (int64_t j = tid; j < nslot * cap; j += blockDim.x) {
        dom_sum0[j] = T(0);
        dom_flag0[j] = 0;
      }
    }
  };

  for (int64_t j = i0; j < N * R; j += istep) req[j] = ((const T*)a.requested0)[j];
  for (int64_t j = i0; j < N * 2; j += istep) nzc[j] = ((const T*)a.nonzero0)[j];
  for (int64_t j = i0; j < N; j += istep) pc[j] = ((const T*)a.pod_count0)[j];
  if (spread_on) {
    for (int64_t j = i0; j < a.SG * N; j += istep) spc[j] = ((const T*)a.spread_counts0)[j];
  }
  if (ipa) {
    for (int64_t j = i0; j < GD; j += istep) {
      isel[j] = ((const T*)a.ip_sel0)[j];
      iown[j] = ((const T*)a.ip_own0)[j];
      ianti[j] = ((const T*)a.ip_anti0)[j];
    }
  }
  if (ports) copy_transposed((const T*)a.ports_used0, sports, N, a.PT, i0, istep);
  if (restr) copy_transposed((const T*)a.restr_used0, srestr, N, a.VR, i0, istep);
  if (cloud) copy_transposed((const T*)a.cloud_used0, scloud, N, 3, i0, istep);
  if (csi) copy_transposed((const T*)a.csi_attached0, scsi, N, a.VID, i0, istep);
  if (csi) {
    // attached ids per (driver, node): the reference's csi_att @ csi_drv_oh
    // (bits other blocks of the cluster copied)
    csync();
    for (int64_t n = i0; n < N; n += istep) {
      for (int64_t d = 0; d < a.DR; ++d) scnt[d * N + n] = T(0);
      for (int64_t v = 0; v < a.VID; ++v) {
        const int d = a.csi_drv[v];
        if (scsi[v * N + n] && d >= 0) scnt[d * N + n] = scnt[d * N + n] + T(1);
      }
    }
    __syncthreads();
  }
  // K2g's residual starts at zero: each block zeroes its stretch
  for (int64_t j = i0; GRAD && j < 2 * a.ns * N; j += istep) a.resid[j] = 0.0;
  zero_domains();
  csync();

  // trace meta: per-score min/max of where(feasible & active, raw, 0) over
  // [P,N], and the max failure code; each cluster block over its nodes,
  // block 0 alone of the redundant chains
  T meta_mn[MAXS], meta_mx[MAXS];
  for (int k = 0; k < MAXS; ++k) {
    meta_mn[k] = T(INFINITY);
    meta_mx[k] = T(-INFINITY);
  }
  int code_mx = 0;
  const bool meta = trace && (CL || b == 0);

  int start = a.start_ptr ? a.start_ptr[0] : (int)a.start0;
  for (int64_t i = 0; i < P; ++i) {
    // the trace: a cluster block writes its rank tiles' columns of every
    // pod, a redundant chain the rows of its pods
    const bool owner = (i % B) == b;
    const bool writes = trace && (CL || owner);
    const bool active = a.pod_active[i] != 0;
    const int tol = a.pod_tol_idx[i];
    const int affi = a.pod_aff_idx[i];
    const int prefi = a.pod_pref_idx[i];
    const int imgi = a.pod_img_idx[i];
    const int tgt = a.name_target[i];
    const T* preq = pod_req + i * R;
    const T* pnz = pod_nonzero + i * 2;
    const uint8_t* fchk = a.fit_checked + i * R;
    const int32_t* fkey = a.spf_key + i * a.KC;
    const int32_t* fgrp = a.spf_grp + i * a.KC;
    const int32_t* fku = a.spf_ku + i * a.KC;
    const int32_t* skey = a.sps_key + i * a.KS;
    const int32_t* sgrp = a.sps_grp + i * a.KS;
    const int32_t* sku = a.sps_ku + i * a.KS;
    const bool sp_f = TOPO && a.use_spread_f != 0;
    const bool sp_s = TOPO && a.use_spread_s && skey[0] >= 0;
    const int32_t* pcols = a.port_cols + i * a.KPT;
    const int32_t* rcols = a.restr_cols + i * a.KVR;
    const int32_t* ccols = a.csi_cols + i * a.KV;
    const T* ccnt = (const T*)a.cloud_cnt + i * 3;
    const int voli = a.pod_vol_idx[i];

    // ---- pass 0: PodTopologySpread domain sums and minima ---------------
    T min_match[MAXC], w_log[MAXC];
    if (sp_f || sp_s) {
      // (a cluster's were zeroed after the previous pod)
      for (int k = 0; !CL && k < nslot; ++k) {
        const int key = k < a.KC ? fkey[k] : skey[k - a.KC];
        const int u = k < a.KC ? fku[k] : sku[k - a.KC];
        if (key < 0 || a.key_size[u] == 0) continue;
        for (int64_t d = tid; d < a.key_size[u]; d += blockDim.x) {
          dom_sum[k * cap + d] = T(0);
          dom_flag[k * cap + d] = 0;
        }
      }
      if constexpr (!CL) __syncthreads();
      T lmin[MAXC];
      for (int k = 0; k < MAXC; ++k) lmin[k] = INF;
      // this block's nodes: all, or its tiles' (any split gives the same sums)
      for (int64_t base = T0; base < N; base += TSTEP) {
        const int64_t n = base + tid;
        if (n >= N) continue;
        if (sp_f) {
          const bool incl = a.incl_cls[(int64_t)affi * a.M_cols + a.node_label_idx[n]] != 0;
          for (int k = 0; k < a.KC; ++k) {
            if (fkey[k] < 0) continue;
            const int dom = a.node_domain[(int64_t)fkey[k] * N + n];
            if (dom < 0 || !incl) continue;  // not a contributing node
            const T m = spc[(int64_t)fgrp[k] * N + n];
            if (a.key_size[fku[k]] == 0) {
              lmin[k] = m < lmin[k] ? m : lmin[k];
            } else {
              const int64_t d = k * cap + (dom - a.key_base[fku[k]]);
              atomicAdd(&dom_sum[d], m);
              dom_flag[d] = 1;
            }
          }
        }
        if (sp_s && has_all_keys(a, skey, n)) {
          for (int k = 0; k < a.KS; ++k) {
            if (skey[k] < 0 || a.key_size[sku[k]] == 0) continue;
            const int dom = a.node_domain[(int64_t)skey[k] * N + n];
            atomicAdd(&dom_sum[(a.KC + k) * cap + (dom - a.key_base[sku[k]])], spc[(int64_t)sgrp[k] * N + n]);
          }
        }
      }
      if (split) {
        // the cluster's minima over nodes, and its domain sums complete
        for (int k = 0; sp_f && k < a.KC; ++k) {
          if (fkey[k] < 0) continue;
          const T v = block_reduce(lmin[k], INF, MinOp());
          if (tid == 0) cx.lmin[k] = v;
        }
        cluster_sync();
        if (sp_f && tid < 32) {
          // every remote read before the first store, which the compiler
          // cannot order them past
          const ClusterX<T>* x = at_rank(&cx, tid < B ? tid : 0);
          T v[MAXC];
#pragma unroll
          for (int k = 0; k < MAXC; ++k) v[k] = k < a.KC && fkey[k] >= 0 ? x->lmin[k] : INF;
#pragma unroll
          for (int k = 0; k < MAXC; ++k) {
            const T m = warp_combine(v[k], MinOp());
            if (tid == 0 && k < a.KC) cx.out_t[k] = m;
          }
        }
        __syncthreads();
        for (int k = 0; sp_f && k < a.KC; ++k) {
          if (fkey[k] >= 0) lmin[k] = cx.out_t[k] < lmin[k] ? cx.out_t[k] : lmin[k];
        }
      } else {
        __syncthreads();
      }
      if (sp_f) {
        for (int k = 0; k < a.KC; ++k) {
          if (fkey[k] < 0) continue;
          T v = lmin[k];
          const int64_t size = a.key_size[fku[k]];
          for (int64_t d = tid; d < size; d += blockDim.x) {
            if (dom_flag[k * cap + d] && dom_sum[k * cap + d] < v) v = dom_sum[k * cap + d];
          }
          v = block_reduce(v, INF, MinOp());
          // finite iff some domain (node) contributes: counts are finite
          min_match[k] = v == INF ? T(0) : v;
        }
      }
    }

    // InterPodAffinity: existing matches of the required-affinity groups
    const bool has_aff = ipa && a.KA > 0 && a.ip_aff_g[i * a.KA] >= 0;
    bool aff_escape = false;
    if (has_aff) {
      T s = T(0);
      for (int k = 0; k < a.KA; ++k) {
        const int g = a.ip_aff_g[i * a.KA + k];
        if (g < 0) continue;
        for (int64_t d = tid; d < a.D; d += blockDim.x) s = s + isel[(int64_t)g * (a.D + 1) + d];
      }
      s = block_reduce(s, T(0), SumOp());
      aff_escape = s == T(0) && a.ip_self_match[i] != 0;
    }

    // ---- pass 1: filters, rotated prefix sum, sampling ----------------
    int run = 0;
    int kth_rank = -1;
    int c_hi = 0;  // sampled nodes of id >= start (in-step compaction)
    int n_fni = 0;  // sampled nodes with every score key
    T mx_taint = -INFINITY, mx_aff = -INFINITY;
    T ip_mn = INF, ip_mx = -INF;
    const int32_t* mg = a.ip_match_g + i * a.KM;  // the groups whose term selects the pod
    // a feasible node at running count c (in visit order): sampled while c
    // <= K; its taint/affinity/InterPodAffinity extrema and sampled domains
    auto sample = [&](int r, int n, int feas, int c, T ip_raw) {
      const bool samp = feas && c <= K;
      if (feas && c == K) kth_rank = r;
      if (ws0 > 0) {
        srank[n] = c;
        if (samp && r < nt - start) c_hi = c;
      }
      fl[n] = (uint8_t)(feas | (samp ? 2 : 0));
      const int64_t tcell = (int64_t)tol * a.T_cols + a.node_taint_idx[n];
      const T vt = samp ? T(a.taint_prefer_cls[tcell]) : T(0);
      const T va = samp ? T(a.aff_pref_cls[(int64_t)prefi * a.MP_cols + a.node_label_idx[n]]) : T(0);
      mx_taint = vt > mx_taint ? vt : mx_taint;
      mx_aff = va > mx_aff ? va : mx_aff;
      if (samp && ipa_scored) {
        ip_mn = ip_raw < ip_mn ? ip_raw : ip_mn;
        ip_mx = ip_raw > ip_mx ? ip_raw : ip_mx;
      }
      if (samp && sp_s && has_all_keys(a, skey, n)) {
        ++n_fni;
        for (int k = 0; k < a.KS; ++k) {
          if (skey[k] < 0 || a.key_size[sku[k]] == 0) continue;
          const int dom = a.node_domain[(int64_t)skey[k] * N + n];
          dom_flag[(a.KC + k) * cap + (dom - a.key_base[sku[k]])] = 1;
        }
      }
    };
    for (int64_t base = T0, tile = 0; base < N; base += TSTEP, ++tile) {
      const int r = (int)(base + tid);
      int n = -1;
      int feas = 0;
      T ip_raw = T(0);
      if (r < N) {
        n = r < nt ? (start + r) % nt : r;
        const int ntaint = a.node_taint_idx[n];
        const int nlabel = a.node_label_idx[n];
        bool ok = node_act[n] != 0;
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
            case F_VB:
              code = a.vb_cls[(int64_t)voli * a.VB_cols + nlabel];
              break;
            case F_VZ:
              code = a.vz_cls[(int64_t)voli * a.VB_cols + nlabel];
              break;
            case F_PORTS:
            case F_RESTR: {
              // the used counts (in wanted-class conflict space) at the
              // pod's own classes
              const bool is_ports = a.filters[k] == F_PORTS;
              if (!(is_ports ? ports : restr)) break;
              const int32_t* cols = is_ports ? pcols : rcols;
              const T* used = is_ports ? sports : srestr;
              T clash = T(0);
              for (int c = 0; c < (is_ports ? a.KPT : a.KVR) && cols[c] >= 0; ++c) clash = clash + used[(int64_t)cols[c] * N + n];
              code = clash > T(0) ? 1 : 0;
              break;
            }
            case F_EBS:
            case F_GCE:
            case F_AZURE: {
              if (!cloud) break;
              const int col = (int)a.filters[k] - F_EBS;
              const T want = ccnt[col];
              code = (want > T(0) && scloud[col * N + n] + want > T(a.cloud_limit[col])) ? 1 : 0;
              break;
            }
            case F_CSI: {
              // per driver of the pod's not yet attached ids: seeded +
              // attached + new ones over the node's limit
              if (!csi) break;
              for (int c = 0; c < a.KV && ccols[c] >= 0 && code == 0; ++c) {
                const int d = a.csi_drv[ccols[c]];
                if (scsi[(int64_t)ccols[c] * N + n] || d < 0) continue;
                T need = T(0);
                for (int c2 = 0; c2 < a.KV && ccols[c2] >= 0; ++c2) {
                  if (!scsi[(int64_t)ccols[c2] * N + n] && a.csi_drv[ccols[c2]] == d) need = need + T(1);
                }
                const T used = ((const T*)a.csi_seed_used)[n * a.DR + d] + scnt[(int64_t)d * N + n];
                if (used + need > ((const T*)a.csi_limit)[n * a.DR + d]) code = 1;
              }
              break;
            }
            case F_SPREAD: {
              if (!sp_f) break;
              const bool incl = a.incl_cls[(int64_t)affi * a.M_cols + nlabel] != 0;
              for (int c = 0; c < a.KC; ++c) {
                if (fkey[c] < 0) continue;
                const int dom = a.node_domain[(int64_t)fkey[c] * N + n];
                int c_code = 1;
                if (dom >= 0) {
                  const T match = a.key_size[fku[c]] == 0
                      ? (incl ? spc[(int64_t)fgrp[c] * N + n] : T(0))
                      : dom_sum[c * cap + (dom - a.key_base[fku[c]])];
                  const T skew = match + ((const T*)a.spf_self)[i * a.KC + c] - min_match[c];
                  c_code = skew > ((const T*)a.spf_skew)[i * a.KC + c] ? 2 : 0;
                }
                if (code == 0) code = c_code;
              }
              break;
            }
            case F_IPA: {
              if (!ipa) break;
              // existing pods' required anti-affinity toward this pod
              for (int c = 0; c < a.KM && mg[c] >= 0 && code == 0; ++c) {
                if (at_node(a, ianti, mg[c], n) > T(0)) code = 1;
              }
              if (code == 0 && has_aff && !aff_escape) {
                bool sat = true;
                for (int c = 0; c < a.KA; ++c) {
                  const int g = a.ip_aff_g[i * a.KA + c];
                  if (g >= 0) sat = sat && a.gdom[(int64_t)g * N + n] >= 0 && at_node(a, isel, g, n) > T(0);
                }
                if (!sat) code = 2;
              }
              for (int c = 0; c < a.KB && code == 0; ++c) {
                const int g = a.ip_anti_g[i * a.KB + c];
                if (g >= 0 && at_node(a, isel, g, n) > T(0)) code = 3;
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
        if (ipa_scored) {
          for (int c = 0; c < a.KM && mg[c] >= 0; ++c) ip_raw = ip_raw + at_node(a, iown, mg[c], n);
          for (int c = 0; c < a.KP; ++c) {
            const int g = a.ip_pref_g[i * a.KP + c];
            if (g >= 0) ip_raw = ip_raw + ((const T*)a.ip_pref_w)[i * a.KP + c] * at_node(a, isel, g, n);
          }
          ipraw[n] = ip_raw;
        }
      }
      int tile_total;
      const int c_tile = block_scan(feas, &tile_total);
      if (split) {
        // sampled once the cluster's counts before this tile are known
        if (r < N) {
          srank[n] = c_tile;
          fl[n] = (uint8_t)feas;
        }
        if (tid == 0) cx.tile_feas[tile] = tile_total;
      } else {
        const int c = run + c_tile;
        run += tile_total;
        if (r < N) sample(r, n, feas, c, ip_raw);
      }
    }
    if (split) {
      // tile t (rank order) is block t % C's (t / C)-th: its feasible count,
      // exclusive-scanned over the cluster's tiles
      cluster_sync();
      const int ntiles = (int)((N + THREADS - 1) / THREADS);
      const int v = tid < ntiles ? at_rank(&cx, tid % B)->tile_feas[tid / B] : 0;
      const int incl = block_scan(v, &run);
      if (tid < ntiles) tile_off[tid] = incl - v;
      __syncthreads();
      for (int64_t base = T0; base < N; base += TSTEP) {
        const int r = (int)(base + tid);
        if (r >= N) continue;
        const int n = r < nt ? (start + r) % nt : r;
        sample(r, n, fl[n] & 1, tile_off[base / THREADS] + srank[n], ipa_scored ? ipraw[n] : T(0));
      }
    }
    const int total = run;
    kth_rank = block_reduce(kth_rank, -1, MaxOp());
    mx_taint = block_reduce(mx_taint, T(-INFINITY), MaxOp());
    mx_aff = block_reduce(mx_aff, T(-INFINITY), MaxOp());
    if (ipa_scored) {
      ip_mn = block_reduce(ip_mn, INF, MinOp());
      ip_mx = block_reduce(ip_mx, -INF, MaxOp());
    }
    if (ws0 > 0) c_hi = block_reduce(c_hi, 0, MaxOp());
    if (split) {
      // the cluster's: the sampled-domain flags land in rank 0's copy too
      if (sp_s) n_fni = block_reduce(n_fni, 0, SumOp());
      if (tid == 0) {
        cx.kth = kth_rank;
        cx.n_fni = n_fni;
        cx.c_hi = c_hi;
        cx.mx_taint = mx_taint;
        cx.mx_aff = mx_aff;
        cx.ip_mn = ip_mn;
        cx.ip_mx = ip_mx;
      }
      cluster_sync();
      if (tid < 32) {
        const bool in = tid < B;
        const ClusterX<T>* x = at_rank(&cx, in ? tid : 0);
        const int kth = warp_combine(x->kth, MaxOp());
        const int nf = warp_combine(in ? x->n_fni : 0, SumOp());
        const int ch = warp_combine(x->c_hi, MaxOp());
        const T mt = warp_combine(x->mx_taint, MaxOp());
        const T ma = warp_combine(x->mx_aff, MaxOp());
        const T mn = warp_combine(x->ip_mn, MinOp());
        const T mx = warp_combine(x->ip_mx, MaxOp());
        if (tid == 0) {
          cx.out_i[0] = kth;
          cx.out_i[1] = nf;
          cx.out_i[2] = ch;
          cx.out_t[0] = mt;
          cx.out_t[1] = ma;
          cx.out_t[2] = mn;
          cx.out_t[3] = mx;
        }
      }
      __syncthreads();
      kth_rank = cx.out_i[0];
      n_fni = cx.out_i[1];
      c_hi = cx.out_i[2];
      mx_taint = cx.out_t[0];
      mx_aff = cx.out_t[1];
      ip_mn = cx.out_t[2];
      ip_mx = cx.out_t[3];
    }
    const int processed = total >= K ? kth_rank + 1 : nt;
    const int n_samp = total < K ? total : K;
    const int count = n_samp * (active ? 1 : 0);

    // ---- pass 1b: PodTopologySpread's raw score and its extrema ---------
    T sp_mn = INF, sp_mx = -INF;
    if (sp_s) {
      // topology size: sampled nodes (identity key) or sampled domains (a
      // cluster's n_fni is already its total)
      if (!split) n_fni = block_reduce(n_fni, 0, SumOp());
      for (int k = 0; k < a.KS; ++k) {
        if (skey[k] < 0) continue;
        int tsize = n_fni;
        const int64_t size = a.key_size[sku[k]];
        if (size > 0) {
          int cnt = 0;
          for (int64_t d = tid; d < size; d += blockDim.x) cnt += dom_flag[(a.KC + k) * cap + d];
          tsize = block_reduce(cnt, 0, SumOp());
        }
        w_log[k] = log_table[tsize];
      }
      // every node, or in a cluster the nodes of this block's rank tiles
      for (int64_t base = T0; base < N; base += TSTEP) {
        const int64_t r = base + tid;
        if (r >= N) continue;
        const int64_t n = !CL || r >= nt ? r : (start + r) % nt;
        const bool all_keys = has_all_keys(a, skey, n);
        T raw_f = T(0);
        for (int k = 0; k < a.KS; ++k) {
          if (skey[k] < 0) continue;
          const int dom = a.node_domain[(int64_t)skey[k] * N + n];
          T cnt;
          if (a.key_size[sku[k]] == 0) {
            cnt = all_keys ? spc[(int64_t)sgrp[k] * N + n] : T(0);
          } else {
            cnt = dom >= 0 ? dom_sum[(a.KC + k) * cap + (dom - a.key_base[sku[k]])] : T(0);
          }
          raw_f = raw_f + (cnt * w_log[k] + (((const T*)a.sps_skew)[i * a.KS + k] - T(1)));
        }
        const T raw = d_rint(raw_f);
        spraw[n] = raw;
        if (all_keys) {
          fl[n] |= 4;
          if (fl[n] & 2) {
            sp_mn = raw < sp_mn ? raw : sp_mn;
            sp_mx = raw > sp_mx ? raw : sp_mx;
          }
        }
      }
      sp_mn = block_reduce(sp_mn, INF, MinOp());
      sp_mx = block_reduce(sp_mx, -INF, MaxOp());
      if (split) {
        if (tid == 0) {
          cx.sp_mn = sp_mn;
          cx.sp_mx = sp_mx;
        }
        cluster_sync();
        if (tid < 32) {
          const ClusterX<T>* x = at_rank(&cx, tid < B ? tid : 0);
          const T mn = warp_combine(x->sp_mn, MinOp());
          const T mx = warp_combine(x->sp_mx, MaxOp());
          if (tid == 0) {
            cx.out_t[0] = mn;
            cx.out_t[1] = mx;
          }
        }
        __syncthreads();
        sp_mn = cx.out_t[0];
        sp_mx = cx.out_t[1];
      }
    }

    // ---- pass 2: scores, weighted totals -------------------------------
    T best = -INFINITY;
    for (int64_t base = T0; base < N; base += TSTEP) {
      const int r = (int)(base + tid);
      if (r < N) {
        const int n = r < nt ? (start + r) % nt : r;
        const bool samp = (fl[n] & 2) != 0;
        const int ntaint = a.node_taint_idx[n];
        const int nlabel = a.node_label_idx[n];
        T total_w = T(0);
        for (int k = 0; k < a.ns; ++k) {
          T raw = T(0), nrm = T(0);
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
            case S_AFF:
              raw = T(a.aff_pref_cls[(int64_t)prefi * a.MP_cols + nlabel]);
              nrm = default_normalize(raw, mx_aff, false);
              break;
            case S_SPREAD:
              if (!sp_s) break;
              raw = spraw[n];
              // nodes without every key, or no sampled node with them: 0
              if ((fl[n] & 4) && sp_mn != INF) {
                nrm = sp_mx == T(0) ? T(100) : floordiv(T(100) * (sp_mx + sp_mn - raw), sp_mx);
              }
              break;
            default: {  // S_IPA: MAX * (raw - min) / (max - min) over the sampled nodes
              if (!ipa) break;
              raw = ipraw[n];
              const T diff = ip_mx - ip_mn;
              nrm = diff > T(0) ? d_floor(T(100) * (raw - ip_mn) / diff) : T(0);
              break;
            }
          }
          if (writes && ws0 == 0) {
            ((T*)a.raw[k])[i * N + n] = raw;
            ((T*)a.norm[k])[i * N + n] = nrm;
          } else if (writes && samp) {
            // rank in ascending node id among the sampled nodes
            const int rank = srank[n] - 1;
            const int pos = r < nt - start ? (n_samp - c_hi) + rank : rank - c_hi;
            if (pos < ws0) {
              ((T*)a.raw[k])[i * ws0 + pos] = raw;
              ((T*)a.norm[k])[i * ws0 + pos] = nrm;
            }
          }
          // meta reads where(feasible & active, raw, 0): over [P,N], or
          // over [P,ws0] with a column valid below the pod's count
          if (meta && (ws0 == 0 || (samp && active))) {
            const T v = (samp && active) ? raw : T(0);
            meta_mn[k] = v < meta_mn[k] ? v : meta_mn[k];
            meta_mx[k] = v > meta_mx[k] ? v : meta_mx[k];
          }
          if (GRAD) snorm[k * N + n] = nrm;
          total_w = total_w + nrm * wrow[k];
        }
        const T masked = samp ? total_w : NEG;
        tot[n] = masked;
        best = masked > best ? masked : best;
        if (writes && ws0 == 0) a.feasible[i * N + n] = samp ? 1 : 0;
      }
    }
    if (ws0 > 0) {
      // the compacted rows past the sampled nodes are zero (each block its
      // stretches of them), and hold a masked (zero) column for the meta
      // when the pod's count is below ws0
      for (int64_t j = n_samp + i0; writes && j < ws0; j += istep) {
        for (int k = 0; k < a.ns; ++k) {
          ((T*)a.raw[k])[i * ws0 + j] = T(0);
          ((T*)a.norm[k])[i * ws0 + j] = T(0);
        }
      }
      if (meta && tid == 0 && count < ws0) {
        for (int k = 0; k < a.ns; ++k) {
          meta_mn[k] = T(0) < meta_mn[k] ? T(0) : meta_mn[k];
          meta_mx[k] = T(0) > meta_mx[k] ? T(0) : meta_mx[k];
        }
      }
    }
    best = block_reduce(best, T(-INFINITY), MaxOp());

    // ---- K2g: the block's softmax sums -----------------------------------
    // s = softmax(totals / tau) over the sampled nodes.  Each block sums e =
    // exp(z - its own max) and e norm_k over its nodes in one tree (its max
    // is its best total over tau: IEEE division by tau > 0 is monotone);
    // the selection's exchange carries them, rescaled to the cluster's max
    // (grad_combine), so the grad mode adds no cluster barrier
    const T tau = T(a.tau);
    if constexpr (GRAD) {
      const T zb = best / tau;
      T part[MAXS + 1];
#pragma unroll
      for (int k = 0; k <= MAXS; ++k) part[k] = T(0);
      for (int64_t base = T0; base < N; base += TSTEP) {
        const int r = (int)(base + tid);
        if (r >= N) continue;
        const int n = r < nt ? (start + r) % nt : r;
        if (!(fl[n] & 2)) continue;
        const T e = d_exp(tot[n] / tau - zb);
        part[0] = part[0] + e;
#pragma unroll
        for (int k = 0; k < MAXS; ++k) {
          if (k < a.ns) part[k + 1] = part[k + 1] + e * snorm[k * N + n];
        }
      }
      block_sums(part, (int)a.ns + 1, cx.g_part);
    }
    // warp 0 of a cluster block, lane q holding block q's best total v and
    // the cluster's gb: the cluster's sums, sum_q exp(v/tau - gb/tau) S_q,
    // into out_t[1..]
    auto grad_combine = [&](const ClusterX<T>* x, T v, T gb) {
      if constexpr (GRAD) {
        T g[MAXS + 1];
#pragma unroll
        for (int k = 0; k <= MAXS; ++k) g[k] = tid < B && k <= a.ns ? x->g_part[k] : T(0);
        const T sc = tid < B ? d_exp(v / tau - gb / tau) : T(0);
#pragma unroll
        for (int k = 0; k <= MAXS; ++k) {
          const T s = warp_combine(g[k] * sc, SumOp());
          if (tid == 0 && k <= a.ns) cx.out_t[1 + k] = s;
        }
      }
    };

    // ---- pass 3: selection ----------------------------------------------
    // (in a cluster, the block whose rank tile holds the selected node
    // commits it and writes the pod's packed row; block 0 when none is)
    int sel_node = -1;
    int committer = 0;
    if (!a.reservoir) {
      // first tied maximum in visit order = minimal visit rank
      int best_rank = 0x7fffffff;
      for (int64_t base = T0; base < N; base += TSTEP) {
        const int r = (int)(base + tid);
        if (r < N) {
          const int n = r < nt ? (start + r) % nt : r;
          if ((fl[n] & 2) && tot[n] == best && r < best_rank) best_rank = r;
        }
      }
      best_rank = block_reduce(best_rank, 0x7fffffff, MinOp());
      if (split) {
        // each block's best total and its first rank, then the cluster's
        if (tid == 0) {
          cx.best = best;
          cx.best_rank = best_rank;
        }
        cluster_sync();
        if (tid < 32) {
          const ClusterX<T>* x = at_rank(&cx, tid < B ? tid : 0);
          const T v = x->best;
          const int vr = x->best_rank;
          const T gb = __shfl_sync(0xffffffffu, warp_combine(v, MaxOp()), 0);
          const int gr = warp_combine(v == gb ? vr : 0x7fffffff, MinOp());
          grad_combine(x, v, gb);
          if (tid == 0) {
            cx.out_t[0] = gb;
            cx.out_i[0] = gr;
          }
        }
        __syncthreads();
        best = cx.out_t[0];
        best_rank = cx.out_i[0];
        if (best_rank != 0x7fffffff) {
          // the owner of the node's rank tile, in this pod or the next
          int rk = best_rank;
          if (!commit_sync && best_rank < nt) {
            const int nstart = active ? (start + processed) % nt : start;
            rk = ((start + best_rank) % nt - nstart + nt) % nt;
          }
          committer = (rk / THREADS) % B;
        }
      }
      if (best_rank != 0x7fffffff) sel_node = best_rank < nt ? (start + best_rank) % nt : best_rank;
    } else if (!split) {
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
    } else {
      // a cluster's reservoir draw: the best total, each rank tile's ties at
      // it exclusive-scanned in rank order, and the tile holding the k-th
      if (tid == 0) cx.best = best;
      cluster_sync();
      if (tid < 32) {
        const ClusterX<T>* x = at_rank(&cx, tid < B ? tid : 0);
        const T v = x->best;
        const T gb = __shfl_sync(0xffffffffu, warp_combine(v, MaxOp()), 0);
        grad_combine(x, v, gb);
        if (tid == 0) cx.out_t[0] = gb;
      }
      __syncthreads();
      best = cx.out_t[0];
      for (int64_t base = T0, tile = 0; base < N; base += TSTEP, ++tile) {
        const int r = (int)(base + tid);
        int tied = 0;
        if (r < N) {
          const int n = r < nt ? (start + r) % nt : r;
          tied = ((fl[n] & 2) && tot[n] == best) ? 1 : 0;
        }
        const int t_tied = block_reduce(tied, 0, SumOp());
        if (tid == 0) cx.tile_tied[tile] = t_tied;
      }
      cluster_sync();
      const int ntiles = (int)((N + THREADS - 1) / THREADS);
      const int v = tid < ntiles ? at_rank(&cx, tid % B)->tile_tied[tid / B] : 0;
      int t_count;
      const int incl = block_scan(v, &t_count);
      if (tid < ntiles) tile_off[tid] = incl - v;
      const uint32_t counter = (uint32_t)((uint64_t)a.tb_base + (uint64_t)i);
      const uint32_t draw = mix32((uint32_t)a.seed_mix ^ mix32(counter));
      const int kk = (int)(draw % (uint32_t)(t_count > 1 ? t_count : 1));
      const int t_sel = block_reduce(v > 0 && incl - v <= kk && kk < incl ? tid : -1, -1, MaxOp());
      if (t_sel >= 0) {
        committer = t_sel % B;
        if (b == committer) {
          const int r = t_sel * THREADS + tid;
          int tied = 0, n = -1;
          if (r < N) {
            n = r < nt ? (start + r) % nt : r;
            tied = ((fl[n] & 2) && tot[n] == best) ? 1 : 0;
          }
          int tile_total;
          const int ct = tile_off[t_sel] + block_scan(tied, &tile_total);
          sel_node = block_reduce(tied && ct == kk + 1 ? n : -1, -1, MaxOp());
        }
      }
    }
    const int sel = count > 0 ? sel_node : -1;
    const bool commits = !CL || b == committer;

    // ---- K2g: this pod's term of the residual M --------------------------
    // each node's owner adds pnz_j s[n] (norm_k[n] - nbar_k) to M[j,k,n],
    // with s = exp(z - max) / sum e and nbar_k = sum e norm_k / sum e
    if constexpr (GRAD) {
      if (count > 0) {
        const T zmax = best / tau;
        const T* sums = split ? cx.out_t + 1 : cx.g_part;
        const T esum = sums[0];
        const int64_t SN = a.ns * N;
        for (int64_t base = T0; base < N; base += TSTEP) {
          const int r = (int)(base + tid);
          if (r >= N) continue;
          const int n = r < nt ? (start + r) % nt : r;
          if (!(fl[n] & 2)) continue;
          const double s = (double)(d_exp(tot[n] / tau - zmax) / esum);
          T nk[MAXS];
#pragma unroll
          for (int k = 0; k < MAXS; ++k) {
            if (k < a.ns) nk[k] = snorm[k * N + n];
          }
          // each half's loads before its stores: two round trips to L2, not 2S
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const double p = (double)pnz[j];
            double* m = a.resid + j * SN + n;
            double old[MAXS];
#pragma unroll
            for (int k = 0; k < MAXS; ++k) {
              if (k < a.ns) old[k] = m[k * N];
            }
#pragma unroll
            for (int k = 0; k < MAXS; ++k) {
              if (k < a.ns) m[k * N] = old[k] + p * (s * ((double)nk[k] - (double)(sums[1 + k] / esum)));
            }
          }
        }
      }
    }

    // ---- commit: one writer per node ------------------------------------
    if (sel >= 0 && commits && tid == 0) {
      for (int64_t q = 0; q < R; ++q) req[sel * R + q] = req[sel * R + q] + T(1) * preq[q];
      nzc[sel * 2 + 0] = nzc[sel * 2 + 0] + T(1) * pnz[0];
      nzc[sel * 2 + 1] = nzc[sel * 2 + 1] + T(1) * pnz[1];
      pc[sel] = pc[sel] + T(1);
    }
    if (sel >= 0 && VOL && commits) {
      // host ports and conflict volumes: the pod's classes projected
      // through the conflict relation, one thread per wanted class
      for (int64_t w = tid; ports && w < a.PT; w += blockDim.x) {
        T proj = T(0);
        for (int c = 0; c < a.KPT && pcols[c] >= 0; ++c) proj = proj + ((const T*)a.port_conflict)[w * a.PT + pcols[c]];
        sports[w * N + sel] = sports[w * N + sel] + T(1) * proj;
      }
      for (int64_t w = tid; restr && w < a.VR; w += blockDim.x) {
        T proj = T(0);
        for (int c = 0; c < a.KVR && rcols[c] >= 0; ++c) proj = proj + ((const T*)a.restr_conflict)[w * a.VR + rcols[c]];
        srestr[w * N + sel] = srestr[w * N + sel] + T(1) * proj;
      }
      if (cloud && tid < 3) scloud[tid * N + sel] = scloud[tid * N + sel] + T(1) * ccnt[tid];
      // CSI ids are set bits (a shared id stays one attachment); their
      // drivers may repeat, so one thread counts them
      if (csi && tid == 0) {
        for (int c = 0; c < a.KV && ccols[c] >= 0; ++c) {
          const int64_t v = ccols[c];
          if (scsi[v * N + sel]) continue;
          scsi[v * N + sel] = 1;
          const int d = a.csi_drv[v];
          if (d >= 0) scnt[(int64_t)d * N + sel] = scnt[(int64_t)d * N + sel] + T(1);
        }
      }
    }
    if (sel >= 0 && spread_on && commits) {
      for (int64_t s = tid; s < a.SG; s += blockDim.x) {
        spc[s * N + sel] = spc[s * N + sel] + ((const T*)a.spread_match)[s * a.Psrc + i];
      }
    }
    if (sel >= 0 && ipa && commits) {
      // one thread per group row of ip_sel; ip_own and ip_anti, whose
      // terms may repeat a cell, on thread 0 in the reference's order
      // a node without the group's key commits to the sink column D
      for (int64_t g = tid; g < a.G; g += blockDim.x) {
        const int d = a.gdom[g * N + sel];
        const int64_t cell = g * (a.D + 1) + (d >= 0 ? d : a.D);
        isel[cell] = isel[cell] + ((const T*)a.term_match)[g * a.Psrc + i];
      }
      if (tid == 0) {
        for (int c = 0; c < a.KO; ++c) {
          const int g = a.ip_own_g[i * a.KO + c];
          if (g < 0) continue;
          const int d = a.gdom[(int64_t)g * N + sel];
          const int64_t cell = (int64_t)g * (a.D + 1) + (d >= 0 ? d : a.D);
          iown[cell] = iown[cell] + ((const T*)a.ip_own_w)[i * a.KO + c];
        }
        for (int c = 0; c < a.KB; ++c) {
          const int g = a.ip_anti_g[i * a.KB + c];
          if (g < 0) continue;
          const int d = a.gdom[(int64_t)g * N + sel];
          const int64_t cell = (int64_t)g * (a.D + 1) + (d >= 0 ? d : a.D);
          ianti[cell] = ianti[cell] + T(1);
        }
      }
    }
    zero_domains();
    if ((CL ? b == committer : owner) && tid == 0) {
      packed[0 * P + i] = sel;
      packed[1 * P + i] = count;
      packed[2 * P + i] = start;
      packed[3 * P + i] = processed;
    }
    // the rotating start advances by the number of visited nodes
    if (active) start = nt > 0 ? (start + processed) % nt : 0;
    if (split && commit_sync) {
      cluster_sync();  // the commit, before the next pod reads the carries
    } else {
      __syncthreads();
    }
  }
  // the trace meta: each block's (block 0's of the redundant chains) into
  // rank 0's slots, read there after the barrier below
  if (meta) {
    ClusterX<T>* x0 = split ? at_rank(&cx, 0) : &cx;
    for (int k = 0; k < a.ns; ++k) {
      const T mn = block_reduce(meta_mn[k], T(INFINITY), MinOp());
      const T mx = block_reduce(meta_mx[k], T(-INFINITY), MaxOp());
      if (tid == 0) {
        x0->m_mn[b][k] = mn;
        x0->m_mx[b][k] = mx;
      }
    }
    const int cm = block_reduce(code_mx, 0, MaxOp());
    if (tid == 0) x0->m_code[b] = cm;
  }
  if (split) cluster_sync();  // every commit and the meta, before the final copy

  // the final carries: block 0's copy, or a cluster's one copy by all its
  // blocks
  if (!CL && b != 0) return;
  for (int64_t i = i0; i < P; i += istep) packed[4 * P + i] = start;
  if (b == 0 && tid == 0) a.final_start[lane] = start;
  // this lane's slices of the final carries
  T* f_req = (T*)a.final_requested + lane * N * R;
  T* f_nz = (T*)a.final_nonzero + lane * N * 2;
  T* f_pc = (T*)a.final_pod_count + lane * N;
  T* f_ports = (T*)a.final_ports_used + lane * N * a.PT;
  T* f_restr = (T*)a.final_restr_used + lane * N * a.VR;
  T* f_cloud = (T*)a.final_cloud_used + lane * N * 3;
  T* f_csi = (T*)a.final_csi_att + lane * N * a.VID;
  T* f_spread = (T*)a.final_spread + lane * a.SG * N;
  T* f_isel = (T*)a.final_ip_sel + lane * GD;
  T* f_iown = (T*)a.final_ip_own + lane * GD;
  T* f_ianti = (T*)a.final_ip_anti + lane * GD;
  for (int64_t j = i0; j < N * R; j += istep) f_req[j] = req[j];
  for (int64_t j = i0; j < N * 2; j += istep) f_nz[j] = nzc[j];
  for (int64_t j = i0; j < N; j += istep) f_pc[j] = pc[j];
  // the volume carries, row-major again (their initial values when the
  // problem carries none)
  auto carry_out = [&](bool on, const auto* cols, T* dst, const T* init, int64_t C) {
    if (on) {
      copy_transposed(cols, dst, C, N, i0, istep);
    } else {
      for (int64_t j = i0; j < N * C; j += istep) dst[j] = init[j];
    }
  };
  carry_out(ports, sports, f_ports, (const T*)a.ports_used0, a.PT);
  carry_out(restr, srestr, f_restr, (const T*)a.restr_used0, a.VR);
  carry_out(cloud, scloud, f_cloud, (const T*)a.cloud_used0, 3);
  carry_out(csi, scsi, f_csi, (const T*)a.csi_attached0, a.VID);
  // PodTopologySpread's and InterPodAffinity's carries, for the next window
  for (int64_t j = i0; j < a.SG * N; j += istep) {
    f_spread[j] = spread_on ? spc[j] : ((const T*)a.spread_counts0)[j];
  }
  for (int64_t j = i0; j < GD; j += istep) {
    f_isel[j] = ipa ? isel[j] : ((const T*)a.ip_sel0)[j];
    f_iown[j] = ipa ? iown[j] : ((const T*)a.ip_own0)[j];
    f_ianti[j] = ipa ? ianti[j] : ((const T*)a.ip_anti0)[j];
  }
  if (!trace || b != 0 || tid != 0) return;
  // min and max are exact in any order
  const int nb = CL ? B : 1;
  for (int k = 0; k < a.ns; ++k) {
    T mn = cx.m_mn[0][k], mx = cx.m_mx[0][k];
    for (int q = 1; q < nb; ++q) {
      mn = cx.m_mn[q][k] < mn ? cx.m_mn[q][k] : mn;
      mx = cx.m_mx[q][k] > mx ? cx.m_mx[q][k] : mx;
    }
    a.trace_meta[2 * k] = (int32_t)mn;
    a.trace_meta[2 * k + 1] = (int32_t)mx;
  }
  int cm = cx.m_code[0];
  for (int q = 1; q < nb; ++q) cm = cx.m_code[q] > cm ? cx.m_code[q] : cm;
  a.trace_meta[2 * a.ns] = 0;
  a.trace_meta[2 * a.ns + 1] = a.nf > 0 ? cm : 0;
}

// The modes build as four libraries, so their nvcc runs go in parallel:
// csrc/scan_cluster.cu, csrc/scan_trace.cu and csrc/scan_grad.cu include
// this file with SCAN_CLUSTER, SCAN_TRACE or SCAN_GRAD defined; built alone
// it holds MODE_BLOCKS.
#if defined(SCAN_GRAD)
constexpr int LIB_MODE = MODE_GRAD;
#elif defined(SCAN_TRACE)
constexpr int LIB_MODE = MODE_TRACE;
#elif defined(SCAN_CLUSTER)
constexpr int LIB_MODE = MODE_CLUSTER;
#else
constexpr int LIB_MODE = MODE_BLOCKS;
#endif

template <typename T, bool TOPO, bool VOL>
cudaError_t launch_vol(const ScanArgs* a, int64_t blocks, size_t smem, void* stream) {
  const dim3 grid((unsigned)blocks, (unsigned)a->lanes);
  if constexpr (LIB_MODE == MODE_BLOCKS) {
    scan_kernel<T, TOPO, VOL, LIB_MODE><<<grid, THREADS, smem, (cudaStream_t)stream>>>(*a);
    return cudaGetLastError();
  } else {
    // one cluster of `blocks` blocks a lane; above 8 a non-portable size
    if (blocks > 8) {
      const cudaError_t e = cudaFuncSetAttribute(scan_kernel<T, TOPO, VOL, LIB_MODE>,
                                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, scan_kernel<T, TOPO, VOL, LIB_MODE>, *a);
  }
}

template <typename T, bool TOPO>
cudaError_t launch_topo(const ScanArgs* a, int64_t blocks, size_t smem, void* stream) {
  if (a->use_ports || a->use_restr || a->use_cloud || a->use_csi) return launch_vol<T, TOPO, true>(a, blocks, smem, stream);
  return launch_vol<T, TOPO, false>(a, blocks, smem, stream);
}

template <typename T>
int launch(const ScanArgs* a, int64_t blocks, void* stream) {
  // the trace planes have no lane stride; gridDim.y is at most 65 535
  if (a->lanes < 1 || a->lanes > 65535 || (a->lanes > 1 && a->trace) || a->ns > MAXS) return (int)cudaErrorInvalidValue;
  // grad mode (its own library): one lane, trace off; the cluster modes'
  // trace is their library's
  if ((a->grad != 0) != (LIB_MODE == MODE_GRAD) || (a->grad && (a->lanes != 1 || a->trace)) ||
      (LIB_MODE != MODE_BLOCKS && (a->trace != 0) != (LIB_MODE == MODE_TRACE))) {
    return (int)cudaErrorInvalidValue;
  }
  if (LIB_MODE == MODE_BLOCKS) {
    if (a->cluster != 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  } else if (a->cluster != blocks || blocks < 1 || blocks > MAXCL ||
             (blocks > 1 && (a->N + THREADS - 1) / THREADS > THREADS)) {
    // `blocks` a cluster, every block at most MAXT of the at most THREADS
    // rank tiles the exchanges take
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = a->dom_smem ? (size_t)((a->KC + a->KS) * a->dom_cap) * (sizeof(T) + sizeof(int)) : 0;
  if (a->use_spread_f || a->use_spread_s || a->use_ipa || a->SG > 0) return (int)launch_topo<T, true>(a, blocks, smem, stream);
  return (int)launch_topo<T, false>(a, blocks, 0, stream);
}

}  // namespace

#if !defined(SCAN_CLUSTER) && !defined(SCAN_TRACE) && !defined(SCAN_GRAD)
extern "C" int kss_scan_f32(const ScanArgs* a, int64_t blocks, void* stream) { return launch<float>(a, blocks, stream); }
extern "C" int kss_scan_f64(const ScanArgs* a, int64_t blocks, void* stream) { return launch<double>(a, blocks, stream); }
#endif
