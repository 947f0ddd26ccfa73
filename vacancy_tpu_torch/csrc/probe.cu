// Warm-up probe for Hopper (sm_90a): out[i] = x[i] * 2.
//
// Replaces the TPU probe kernel of bench.py::_warm_compile (the lambda
// `o = x * 2.0` over f32 [8, 128]; the same body warms the TPU test runner
// and supervisor under tools/). It proves that a kernel of this library
// builds, launches and returns before the bench times anything
// (vacancy_tpu_torch/bench.py::warm_probe). It moves 8 KB, so the launch
// itself bounds it; there is nothing to design around.
//
// The kernel allocates nothing and runs on the caller's stream. The C entry
// point returns the launch's cudaError_t.

#include <cuda_runtime.h>

namespace {

__global__ void probe_scale_kernel(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f;
}

}  // namespace

extern "C" int vt_probe_scale(const float* x, float* out, int n,
                              void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int nt = 128;
  probe_scale_kernel<<<(n + nt - 1) / nt, nt, 0, (cudaStream_t)stream>>>(
      x, out, n);
  return (int)cudaGetLastError();
}
