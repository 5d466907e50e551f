// An empty kernel, for measuring what a launch of a given grid costs by
// itself: the floor that a latency-bound kernel of that grid (the downbeat
// walk, the Viterbi decode) can approach. It is on no analysis path.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches `blocks` x `threads` with `smem` bytes of dynamic shared memory on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int stratum_empty_launch(int blocks, int threads, int smem, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024 || smem < 0 || smem > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  empty_kernel<<<blocks, threads, (size_t)smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
