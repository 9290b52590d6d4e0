// Error strings for the cudaError_t codes the launchers return.

#include <cuda_runtime.h>

extern "C" const char* semslam_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
