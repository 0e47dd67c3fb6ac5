// The scan's grad mode (K2g's forward: the one-lane rollout in a cluster
// of C blocks, folding the residual M over committed pods): csrc/scan.cu
// built with SCAN_GRAD defined, as a library of its own, so that its nvcc
// run goes beside the other two.  The kernel, its argument struct and its
// design notes are scan.cu's.

#define SCAN_GRAD 1
#include "scan.cu"

extern "C" int kss_scan_grad_f32(const ScanArgs* a, int64_t blocks, void* stream) { return launch<float>(a, blocks, stream); }
extern "C" int kss_scan_grad_f64(const ScanArgs* a, int64_t blocks, void* stream) { return launch<double>(a, blocks, stream); }
