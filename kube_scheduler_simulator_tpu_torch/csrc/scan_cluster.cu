// The scan's cluster launches with the trace off (K8 and K9, and the
// one-lane scan of an untraced round: a cluster of C blocks a lane):
// csrc/scan.cu built with SCAN_CLUSTER defined, as a library of its own, so
// that its nvcc run goes beside the others.  The kernel, its argument
// struct and its design notes are scan.cu's.

#define SCAN_CLUSTER 1
#include "scan.cu"

extern "C" int kss_scan_cluster_f32(const ScanArgs* a, int64_t blocks, void* stream) { return launch<float>(a, blocks, stream); }
extern "C" int kss_scan_cluster_f64(const ScanArgs* a, int64_t blocks, void* stream) { return launch<double>(a, blocks, stream); }
