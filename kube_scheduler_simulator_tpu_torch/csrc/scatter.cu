// Row scatter into a plane resident on the card: buf[idx[k], :] = rows[k, :].
//
// Replaces the JAX package's ops/batch.py _scatter_rows / _scatter_donate /
// _scatter_copy (:614-622), the jitted `buf.at[idx].set(rows)` through
// which its DevicePlacer updates a resident problem plane in place when at
// most a quarter of the plane's rows changed between rounds (a few cordoned
// nodes' rows of node_unsched, say).
//
// The plane may be of any dtype and any rank >= 1: the wrapper views it as
// [rows, row_bytes] bytes, so the kernel is a row copy of K * row_bytes
// bytes.  Each thread moves one word of the widest size (8, 4, 2 or 1
// bytes) that divides row_bytes and both base addresses.
//
// Duplicate indices: the placer pads K up to a bucket by repeating the
// first index with its own row, so every duplicate carries an identical
// row, and the order in which the copies land does not matter.
//
// What bounds it on an H100: the launch itself.  K * row_bytes is a few
// kilobytes at most (K <= N/4 rows of a [N] or [N,R] plane); the bytes it
// must move take nanoseconds at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename W>
__global__ void scatter_rows_kernel(W* buf, const int32_t* idx, const W* rows, int64_t k, int64_t row_words) {
  const int64_t total = k * row_words;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < total; j += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = j / row_words, c = j - r * row_words;
    buf[(int64_t)idx[r] * row_words + c] = rows[j];
  }
}

template <typename W>
int launch(void* buf, const int32_t* idx, const void* rows, int64_t k, int64_t row_bytes, void* stream) {
  const int64_t row_words = row_bytes / (int64_t)sizeof(W);
  const int64_t total = k * row_words;
  int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  scatter_rows_kernel<W><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (W*)buf, idx, (const W*)rows, k, row_words);
  return (int)cudaGetLastError();
}

}  // namespace

// word: the copy's word size in bytes (8, 4, 2 or 1), chosen by the wrapper
extern "C" int kss_scatter_rows(void* buf, const int32_t* idx, const void* rows, int64_t k, int64_t row_bytes,
                                int64_t word, void* stream) {
  switch (word) {
    case 8: return launch<uint64_t>(buf, idx, rows, k, row_bytes, stream);
    case 4: return launch<uint32_t>(buf, idx, rows, k, row_bytes, stream);
    case 2: return launch<uint16_t>(buf, idx, rows, k, row_bytes, stream);
    default: return launch<uint8_t>(buf, idx, rows, k, row_bytes, stream);
  }
}
