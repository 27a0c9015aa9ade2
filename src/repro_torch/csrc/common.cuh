// Shared by every kernel library of the port: the error-string export the
// Python loader (kernels/build.py) looks up in each library.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
