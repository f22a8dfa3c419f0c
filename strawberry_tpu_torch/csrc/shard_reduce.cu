// Column sum over shard rows: the one device computation of the parallel
// layer (the fragment-length histogram and the mapped-read count, one row
// per shard or per process, summed between pass 1 and pass 2).
//
// Replaces the jitted `jnp.sum(h, axis=0)` under a 'dp' sharding of
// strawberry_tpu/parallel/collectives.py::allreduce_hist (and the same sum
// over the global mesh in parallel/distributed.py).
//
// out[h] = rows[0][h] + rows[1][h] + ... + rows[N-1][h], added in row order.
// One thread a column, a loop over the N rows; a warp's 32 threads read 32
// consecutive doubles of one row, so every load is coalesced. No atomics
// and no tree whose shape depends on N or on the grid: two runs give the
// same bits, and so does any block size. The rows hold counts (integers far
// below 2^53), so the sums are exact.
//
// What bounds it: nothing on the card. A call moves a few KB (the bytes
// bound is under 0.0001 ms) and the launch takes about a microsecond; the
// rest of a call is the host's path to the launch. So the entry takes the
// device ordinal and switches the current device only when it differs
// (restoring it after), and the Python wrapper binds the entry once and
// enters no device guard: the path from Python to the launch is one
// allocation, one stream query and one ctypes call.
//
// Built by utils/kernels.py with nvcc for sm_90a; plain C interface.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__global__ void shard_colsum_kernel(const double* __restrict__ rows, int N,
                                    int64_t H, double* __restrict__ out) {
  const int64_t h = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  double acc = N > 0 ? rows[h] : 0.0;
  for (int k = 1; k < N; ++k) acc += rows[(int64_t)k * H + h];
  out[h] = acc;
}

}  // namespace

extern "C" {

// rows: (N, H) float64, contiguous, on device `device`; out: (H,) float64
// there; stream: a stream of that device.
int strawb_shard_colsum(const void* rows, int N, long long H, void* out,
                        int device, void* stream) {
  if (N < 0 || H < 0) return cudaErrorInvalidValue;
  if (H == 0) return cudaSuccess;
  const long long blocks = (H + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  shard_colsum_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const double*)rows, N, (int64_t)H, (double*)out);
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

const char* strawb_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
