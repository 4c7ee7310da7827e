// Device stage marks of the transmit step: one empty kernel a boundary, each
// named for it, so that a torch.profiler trace of a step (eager, or a CUDA
// graph's replay) shows where the step's FEC, mapper, frame builder and tail
// begin and end on the card; on the complex tail `ifft` also parts the
// transform from the guard interval and P1 copies.  The port launches them
// only while its tracing is on (dvbt2ll_tpu_torch/observability.py::mark); a
// step captured with tracing off holds none.  A segment of device activity is
// named by the mark that ends it: the kernels between `fec` and `map` are the
// mapper's.
//
// One thread, no memory: a mark costs a launch, a few microseconds of the
// card's time, and as a graph node it orders nothing that the stream does not
// order already.

#include <cuda_runtime.h>

// unmangled, so that a trace shows the names as written
extern "C" __global__ void dvbt2ll_mark_start() {}
extern "C" __global__ void dvbt2ll_mark_fec() {}
extern "C" __global__ void dvbt2ll_mark_map() {}
extern "C" __global__ void dvbt2ll_mark_frames() {}
extern "C" __global__ void dvbt2ll_mark_tail() {}
extern "C" __global__ void dvbt2ll_mark_ifft() {}

// `stage` indexes observability.STAGES: start, fec, map, frames, tail, ifft.
// The mark goes on `stream`, of the current device.  Returns
// cudaGetLastError() after the launch.
extern "C" int dvbt2ll_stage_mark(int stage, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: dvbt2ll_mark_start<<<1, 1, 0, s>>>(); break;
    case 1: dvbt2ll_mark_fec<<<1, 1, 0, s>>>(); break;
    case 2: dvbt2ll_mark_map<<<1, 1, 0, s>>>(); break;
    case 3: dvbt2ll_mark_frames<<<1, 1, 0, s>>>(); break;
    case 4: dvbt2ll_mark_tail<<<1, 1, 0, s>>>(); break;
    case 5: dvbt2ll_mark_ifft<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
