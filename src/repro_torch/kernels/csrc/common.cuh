// Shared by every library of the port: each launcher returns
// cudaGetLastError() as an int, and the Python wrapper turns a non-zero
// code into an exception with this text. Each library is one .cu file,
// so the definition appears once per library.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
