// The lane scan over masked rows (K8: the capacity engine's estimate, one
// node group a lane): csrc/scan.cu built with SCAN_MASKED defined, as a
// library of its own, so that its nvcc run goes beside the others.  The
// kernel, its argument struct and its design notes ("Masked lanes") are
// scan.cu's.

#define SCAN_MASKED 1
#include "scan.cu"

extern "C" int kss_scan_masked_f32(const ScanArgs* a, int64_t blocks, void* stream) { return launch<float>(a, blocks, stream); }
extern "C" int kss_scan_masked_f64(const ScanArgs* a, int64_t blocks, void* stream) { return launch<double>(a, blocks, stream); }
