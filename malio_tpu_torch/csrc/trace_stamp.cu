// Stage stamps for malio_tpu_torch/trace.py: one thread reads the card's
// global timer (%globaltimer, nanoseconds) and writes it into a ring of
// slots in device memory, a slot a replay of a traced program and a column
// a stamp. Launched on the caller's stream, a stamp runs once the work
// queued before it is done, so two stamps bound the device time of what
// lies between them; launched while the stream is captured it becomes a
// node of the CUDA graph and writes at every replay.
//
// The slot comes from a counter in device memory (state[0]): the program's
// first stamp (column 0) takes the next slot, writes the slot's sequence
// number, the program's id and its time, clears the other columns and keeps
// the slot in state[1 + program]; the program's later stamps write their
// column of that slot. So one captured graph fills a new slot at each
// replay, and nothing is read on the host. Stamps of one program must run
// in stream order (one stream at a time), as the traced programs do.
//
// Layout: ring (slots, 2 + cols) int64 rows [seq, program, t_0 .. t_cols-1],
// a column not yet written 0; state (1 + programs) int64, zeroed once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__global__ void stamp_kernel(long long* ring, long long* state, long long slots, int cols,
                             int program, int col) {
  const long long t = global_ns();
  const int width = 2 + cols;
  if (col == 0) {
    const long long seq =
        (long long)atomicAdd(reinterpret_cast<unsigned long long*>(state), 1ULL);
    const long long slot = seq % slots;
    long long* row = ring + slot * width;
    row[0] = seq;
    row[1] = program;
    row[2] = t;
    for (int c = 1; c < cols; ++c) row[2 + c] = 0;
    state[1 + program] = slot;
  } else {
    ring[state[1 + program] * width + 2 + col] = t;
  }
}

__global__ void clock_kernel(long long* out) { *out = global_ns(); }

}  // namespace

// One stamp of `program`, column `col`, on `stream`. Returns the CUDA error
// of the launch (0 on success).
extern "C" int trace_stamp_launch(int64_t* ring, int64_t* state, int64_t slots, int cols,
                                  int program, int col, cudaStream_t stream) {
  stamp_kernel<<<1, 1, 0, stream>>>(reinterpret_cast<long long*>(ring),
                                    reinterpret_cast<long long*>(state), slots, cols, program,
                                    col);
  return (int)cudaGetLastError();
}

// The global timer into *out, on `stream` (the host's calibration: a stamp
// between two readings of its own clock).
extern "C" int trace_clock_launch(int64_t* out, cudaStream_t stream) {
  clock_kernel<<<1, 1, 0, stream>>>(reinterpret_cast<long long*>(out));
  return (int)cudaGetLastError();
}

// Nodes in the graph that `stream` is being captured into, in *nodes; -1
// where the stream is not capturing. Returns a CUDA error (0 on success).
extern "C" int trace_capture_nodes(cudaStream_t stream, int64_t* nodes) {
  *nodes = -1;
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) return 0;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  *nodes = (int64_t)n;
  return 0;
}
