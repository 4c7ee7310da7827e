// Launch settings made once per device, for the launchers of this
// directory: after a device's first launch a launch makes no CUDA runtime
// call but the launch and cudaGetLastError(), so a CUDA graph capture of
// it (dvbt2ll_tpu_torch/compiled.py) records the launch alone.
#pragma once

#include <mutex>

#include <cuda_runtime.h>

namespace dvbt2ll {

constexpr int kMaxDevices = 64;

// A value of type V made once for each device by init(device, &value),
// which returns a cudaError_t, and kept for the process's life.  The
// caller passes the device that is current; the first call for a device
// checks that it is.
template <typename V>
class PerDevice {
 public:
  template <typename Init>
  cudaError_t get(int device, V* out, Init init) {
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mutex_);
    if (!done_[device]) {
      int current = -1;
      cudaError_t err = cudaGetDevice(&current);
      if (err == cudaSuccess && current != device) {
        err = cudaErrorInvalidDevice;
      }
      if (err == cudaSuccess) err = init(device, &values_[device]);
      if (err != cudaSuccess) return err;
      done_[device] = true;
    }
    *out = values_[device];
    return cudaSuccess;
  }

 private:
  std::mutex mutex_;
  bool done_[kMaxDevices] = {};
  V values_[kMaxDevices] = {};
};

}  // namespace dvbt2ll
