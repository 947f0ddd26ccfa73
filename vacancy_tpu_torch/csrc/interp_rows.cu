// Batched 1-D row interpolation for Hopper (sm_90a): kernel C.
//
// Replaces the TPU kernel vacancy_tpu/ops/warp_gather.py::_interp_rows_kernel
// (launched by interp_rows). out[n, r, t] samples the row
// tables[share ? 0 : n, r, :] at pos[n, r, t]: linear between the taps
// floor(p) and floor(p) + 1, or nearest (rounding half up), each tap clamped
// to [lo, hi]. It is the gather of the two-pass warp engine
// (ops/fusion_warp.py) that runs where the fused warp kernel cannot: views
// too tall for its shared-memory intermediate, and orthographic cameras.
//
// What bounds it on the card: it is a gather, bound by memory. Each output
// reads its position and writes its value (8 bytes) and reads one or two
// taps of its row. In pass 1 the shared table is one image (a UHD image is
// 33 MB and stays in the 50 MB L2); in pass 2 a row is one (z, x) column of
// the transposed pass-1 field, so the taps of a row's outputs fall in one or
// two lines of h floats.
// What the design does about it: threads of a block take consecutive t of
// one row, so position reads and output writes are coalesced 128-byte lines
// and neighbouring taps share lines; blocks stride over rows, so no thread
// divides a flat index. Table offsets are 64-bit (a pass-2 table at 1024^3
// and 2160 rows holds 2.3 G elements). Staging rows in shared memory and
// fusing the transpose away are later work.
//
// Numerics: the build uses -fmad=false, and the blend is (1 - frac) * t0
// plus frac * t1, two products and then the sum, as in the plain version
// (ops/warp_gather.py::_sample_rows), so the result is bitwise the same.
//
// The kernel allocates nothing; it runs on the caller's stream. The C entry
// point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(NTHREADS)
interp_rows_kernel(const float* __restrict__ tables,
                   const float* __restrict__ pos, float* __restrict__ out,
                   int n_rows_per_table, int t_len, int width, int share,
                   int linear, int lo, int hi, int64_t n_rows) {
  for (int64_t row = blockIdx.y; row < n_rows; row += gridDim.y) {
    const int64_t n = row / n_rows_per_table;
    const int64_t r = row - n * n_rows_per_table;
    const float* tab =
        tables + ((share ? 0 : n) * n_rows_per_table + r) * (int64_t)width;
    const int64_t base = row * t_len;
    for (int t = blockIdx.x * NTHREADS + threadIdx.x; t < t_len;
         t += gridDim.x * NTHREADS) {
      const float p = pos[base + t];
      float val;
      if (linear) {
        const float p0f = floorf(p);
        const float frac = p - p0f;
        const int p0 = min(max((int)p0f, lo), hi);
        const int p1 = min(p0 + 1, hi);
        const float a = (1.0f - frac) * tab[p0];
        const float b = frac * tab[p1];
        val = a + b;
      } else {
        val = tab[min(max((int)floorf(p + 0.5f), lo), hi)];
      }
      out[base + t] = val;
    }
  }
}

}  // namespace

extern "C" int vt_interp_rows(const float* tables, const float* pos,
                              float* out, int n, int r, int t, int width,
                              int share, int linear, int lo, int hi,
                              void* stream) {
  if (n <= 0 || r <= 0 || t <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  if (lo < 0 || lo > hi || hi >= width) return (int)cudaErrorInvalidValue;
  const int64_t n_rows = (int64_t)n * r;
  const int gx = (t + NTHREADS - 1) / NTHREADS;
  const int gy = n_rows < MAX_GRID_Y ? (int)n_rows : MAX_GRID_Y;
  interp_rows_kernel<<<dim3(gx, gy), NTHREADS, 0, (cudaStream_t)stream>>>(
      tables, pos, out, r, t, width, share, linear, lo, hi, n_rows);
  return (int)cudaGetLastError();
}
