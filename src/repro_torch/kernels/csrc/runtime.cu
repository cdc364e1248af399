// Helpers shared by the kernels' ctypes bindings.

#include <cuda_runtime.h>

// Text of a cudaError_t returned by one of the C entry points.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
