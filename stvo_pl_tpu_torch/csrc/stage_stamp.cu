// Stage stamps: the device's nanosecond clock written into a ring, one row
// per run of a captured program, one column per stamp of the run
// (utils/profiling.py: `stamp`, `StageRing`).
//
// Replaces no TPU kernel.  It exists because a CUDA graph's replay runs no
// Python, so nothing on the host can mark where a stage of the captured VO
// step ends.  Captured on the step's stream, each launch is one kernel node
// that runs once the node before it has finished, so the times of
// consecutive stamps bound a stage's device time.  CUDA events were the
// other way: an event recorded inside a graph is recorded again by the next
// replay before a pipelined host can read it, where here each replay
// writes its own row and the host reads every row afterwards, at one copy.
//
//   slot = counter % rows;  ring[slot * width + k] = %globaltimer;
//   the last stamp of a run (last != 0) also does counter += 1.
//
// What bounds it: one thread, one load, one or two stores; its cost is the
// node's launch inside the graph (a few microseconds).

#include <cuda_runtime.h>

__global__ void stage_stamp_kernel(long long* ring, long long* counter,
                                   int rows, int width, int k, int last) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long slot = *counter % rows;
  ring[slot * width + k] = (long long)t;
  if (last) *counter += 1;
}

extern "C" int stvo_stage_stamp(void* ring, void* counter, int rows,
                                int width, int k, int last, void* stream) {
  if (rows < 1 || width < 1 || k < 0 || k >= width)
    return (int)cudaErrorInvalidValue;
  stage_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)ring, (long long*)counter, rows, width, k, last);
  return (int)cudaGetLastError();
}
