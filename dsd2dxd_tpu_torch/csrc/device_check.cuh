// The device a launch runs on. Every C entry of this library takes the
// index of its tensors' device and refuses (cudaErrorInvalidDevice) when
// the calling thread's current device is another one. The library links
// its own CUDA runtime, apart from PyTorch's: both read the thread's
// current CUDA context, and the Python wrappers make the
// tensors' device current (torch.cuda.device) before they call, so this
// check turns any disagreement into an error instead of a launch on the
// wrong card or on a stream of another device.

#pragma once

#include <cuda_runtime.h>

// One memo slot per device ordinal (finish.cu's occupancy memo).
#define MAX_DEVICES 64

static inline cudaError_t check_device(int want) {
  int dev = -1;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return dev == want && dev < MAX_DEVICES ? cudaSuccess
                                          : cudaErrorInvalidDevice;
}
