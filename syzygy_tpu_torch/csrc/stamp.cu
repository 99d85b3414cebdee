// Layer and part stamps of a replayed frame (sm_90a), and the node count
// of the CUDA graph under capture.
//
// Replaces no TPU kernel: it is the port's own instrumentation
// (renderer/layers.py). While a frame is captured as a CUDA graph, one
// stamp is launched at every boundary of the frame's layers, so the
// graph holds them and every replay writes its own layer times.
//
// A stamp is one thread: it reads the device's global timer
// (%globaltimer, ns) and writes it into a ring of `rows` replays by
// `stride` int64 values, column `mark`. The ring's last column holds the
// replay's sequence number. The frame's first stamp takes the slot
// (sequence % rows) from the device counter `*seq` and writes -1 in that
// column; its last writes the sequence number there, after the times, and
// advances the counter. A reader keeps a slot only where that column
// holds the sequence it expects: a slot written by an older replay, or
// one whose replay has not finished, holds another value.
//
// The boundaries of the parts inside a layer (renderer/layers.py) are
// stamps too, into columns after the layer marks; the host sums a part's
// intervals. A stamp given a raster's tile-list counters (its overflow
// flag and pair count) also copies them into the two columns after its
// mark, for the host to add up.
//
// Bound: the launch. A stamp moves 8-37 bytes; it starts when the kernel
// before it on the stream has ended, so a layer's time is the difference
// of its two stamps and the layers of a replay sum to its device time.

#include <cuda_runtime.h>

#include "launch.h"

namespace {

__global__ void stamp_kernel(long long* ring, long long* seq, int rows, int stride, int mark, int last,
                             const bool* overflow, const int* pairs) {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long n = *seq;
  long long* slot = ring + (n % rows) * stride;
  if (mark == 0) slot[stride - 1] = -1;  // the slot is being written
  slot[mark] = now;
  if (overflow != nullptr) {
    slot[mark + 1] = *overflow ? 1 : 0;
    slot[mark + 2] = *pairs;
  }
  if (last) {
    __threadfence();  // the times before the sequence number
    slot[stride - 1] = n;
    *seq = n + 1;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns a CUDA error, 0
// when the call succeeded.

// Launches one stamp on `stream` of `device`; allocates nothing. With
// `overflow` (and `pairs`) not null, the stamp copies them too.
extern "C" int szg_stamp(long long* ring, long long* seq, int rows, int stride, int mark, int last,
                         const bool* overflow, const int* pairs, int device, void* stream) {
  const int columns = overflow != nullptr ? 3 : 1;  // the time, and the counters after it
  if (rows <= 0 || stride < 2 || mark < 0 || mark + columns > stride - 1) return (int)cudaErrorInvalidValue;
  if ((overflow != nullptr) != (pairs != nullptr)) return (int)cudaErrorInvalidValue;
  if (!szg::valid_device(device)) return (int)cudaErrorInvalidDevice;
  szg::DeviceScope scope(device);
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(ring, seq, rows, stride, mark, last, overflow,
                                                               pairs);
  return (int)cudaGetLastError();
}

// The number of nodes (kernels, memsets, copies) of the graph that
// `stream` is capturing into, in `*nodes`. cudaErrorIllegalState when the
// stream is not capturing.
extern "C" int szg_capture_nodes(void* stream, long long* nodes) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id, &graph);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) return (int)cudaErrorIllegalState;
  size_t count = 0;
  err = cudaGraphGetNodes(graph, nullptr, &count);
  if (err != cudaSuccess) return (int)err;
  *nodes = (long long)count;
  return 0;
}
