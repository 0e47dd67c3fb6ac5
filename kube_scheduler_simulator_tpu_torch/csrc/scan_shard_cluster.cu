// The scan's shard mode with the trace off (an untraced round over a node mesh): csrc/scan.cu built with SCAN_CLUSTER
// defined, its entries launch_shard's, as a library of its own, so that its
// nvcc run goes beside the others.  The kernel, its argument struct, the shard mailbox and
// the design notes are scan.cu's ("SH").

#define SCAN_CLUSTER 1
#include "scan.cu"

extern "C" int kss_scan_shard_cluster_f32(const ScanArgs* h, const ScanArgs* d, int64_t n_local, int64_t blocks,
                                        void* stream) {
  return launch_shard<float>(h, d, n_local, blocks, stream);
}
extern "C" int kss_scan_shard_cluster_f64(const ScanArgs* h, const ScanArgs* d, int64_t n_local, int64_t blocks,
                                        void* stream) {
  return launch_shard<double>(h, d, n_local, blocks, stream);
}
extern "C" int kss_scan_shard_cluster_peer(int64_t dev, int64_t peer) { return shard_peer(dev, peer); }
