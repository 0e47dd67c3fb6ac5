// The scan's cluster launches with the trace on (the one-lane scan of a
// traced round or window: a cluster of C blocks): csrc/scan.cu built with
// SCAN_TRACE defined, as a library of its own, so that its nvcc run goes
// beside the others.  The kernel, its argument struct and its design notes
// are scan.cu's.

#define SCAN_TRACE 1
#include "scan.cu"

extern "C" int kss_scan_trace_f32(const ScanArgs* a, int64_t blocks, void* stream) { return launch<float>(a, blocks, stream); }
extern "C" int kss_scan_trace_f64(const ScanArgs* a, int64_t blocks, void* stream) { return launch<double>(a, blocks, stream); }
