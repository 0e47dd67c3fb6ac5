// The scan's cluster launches (K9 and K8 at C > 1 blocks a lane): csrc/scan.cu
// built with SCAN_CLUSTER defined, as a library of its own, so that its
// nvcc run goes beside scan.cu's instead of after it.  The kernel, its
// argument struct and its design notes are scan.cu's.

#define SCAN_CLUSTER 1
#include "scan.cu"

extern "C" int kss_scan_lanes_f32(const ScanArgs* a, int64_t blocks, void* stream) { return launch<float>(a, blocks, stream); }
extern "C" int kss_scan_lanes_f64(const ScanArgs* a, int64_t blocks, void* stream) { return launch<double>(a, blocks, stream); }
