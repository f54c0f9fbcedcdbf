// Makes `device` current for one C entry point and restores the caller's
// device on the way out.
//
// The library links its own (static) CUDA runtime, and it shares the
// thread's current context with PyTorch's runtime: a cudaSetDevice here
// that is never undone silently changes torch.cuda.current_device(), and
// with it the device of every later event, stream or graph capture that
// names no device. Entry points therefore open with a DeviceGuard and
// return `guard.err` when it is not cudaSuccess.
#pragma once

#include <cuda_runtime.h>

namespace gomp3 {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev_);
    if (err == cudaSuccess && prev_ != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    int now = -1;
    if (prev_ >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev_)
      cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  cudaError_t err;

 private:
  int prev_ = -1;
};

}  // namespace gomp3
