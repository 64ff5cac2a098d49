// Shared entry of the kernel library: the text of a CUDA error code that
// an entry returned (each entry returns cudaGetLastError() after its
// launch; the Python wrapper raises with this text).
#include <cuda_runtime.h>

extern "C" const char* cm3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
