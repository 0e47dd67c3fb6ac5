// The scan's shard mode in the masked lane mode (K8's estimate over a node mesh): csrc/scan.cu built with SCAN_MASKED
// defined, its entries launch_shard's, as a library of its own, so that its
// nvcc run goes beside the others.  The kernel, its argument struct, the shard mailbox and
// the design notes are scan.cu's ("SH").

#define SCAN_MASKED 1
#include "scan.cu"

extern "C" int kss_scan_shard_masked_f32(const ScanArgs* h, const ScanArgs* d, int64_t n_local, int64_t blocks,
                                        void* stream) {
  return launch_shard<float>(h, d, n_local, blocks, stream);
}
extern "C" int kss_scan_shard_masked_f64(const ScanArgs* h, const ScanArgs* d, int64_t n_local, int64_t blocks,
                                        void* stream) {
  return launch_shard<double>(h, d, n_local, blocks, stream);
}
extern "C" int kss_scan_shard_masked_peer(int64_t dev, int64_t peer) { return shard_peer(dev, peer); }
