// The message of a cudaError_t returned by any entry point, for the Python
// wrappers' exceptions.
#include "common.cuh"

VIT_EXPORT const char* vit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
