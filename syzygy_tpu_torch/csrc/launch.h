// Host-side helpers shared by the port's CUDA entry points.
#pragma once

#include <cuda_runtime.h>

namespace szg {

constexpr int MAX_DEVICES = 64;  // the device indices an entry point accepts

inline bool valid_device(int device) { return device >= 0 && device < MAX_DEVICES; }

// Makes `device` current for the launch when it is not, and restores it.
struct DeviceScope {
  int previous = -1;
  explicit DeviceScope(int device) {
    int current = -1;
    if (cudaGetDevice(&current) == cudaSuccess && current != device) {
      cudaSetDevice(device);
      previous = current;
    }
  }
  ~DeviceScope() {
    if (previous >= 0) cudaSetDevice(previous);
  }
};

// A kernel's opt-in to more than 48 KB of dynamic shared memory, made once
// per device (one instance per kernel).
class SharedMemoryOptIn {
 public:
  template <typename Kernel>
  cudaError_t ensure(Kernel kernel, int bytes, int device) {
    if (ready_[device]) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) ready_[device] = true;
    return err;
  }

 private:
  bool ready_[MAX_DEVICES] = {};
};

}  // namespace szg
