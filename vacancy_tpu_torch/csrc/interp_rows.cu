// Batched 1-D row interpolation for Hopper (sm_90a): kernel C.
//
// Replaces the TPU kernel vacancy_tpu/ops/warp_gather.py::_interp_rows_kernel
// (launched by interp_rows). out[n, r, t] samples the row
// tables[share ? 0 : n, r, :] at pos[n, r, t]: linear between the taps
// floor(p) and floor(p) + 1, or nearest (rounding half up), each tap clamped
// to [lo, hi]. It is the gather of the two-pass warp engine
// (ops/fusion_warp.py), which runs what the fused warp kernel's launch plan
// refuses (ops/warp_fused.py::fused_refusal) and cross-checks that kernel.
//
// What bounds it on the card: bytes. Each output reads its position and
// writes its value, 8 bytes for some 15 instructions. In pass 1 every one of
// the N z-planes samples the same image row (a shared table); in pass 2 a
// row is one (z, x) column of the transposed pass-1 field, read by its own
// t outputs only.
// What the design does about it (the launch is chosen in Python,
// ops/warp_gather.py::interp_plan, and passed in; this file checks it):
//  * staged (shared table, t % 4 == 0, positions and outputs 16-byte
//    aligned, the row's taps [lo, hi] within STAGE_BYTES_MAX): a CTA owns
//    one table row r and a group of `group` planes. It copies the row's taps
//    into shared memory once (16-byte cp.async where the row is 16-byte
//    aligned) and produces group x t outputs from that copy, so device memory
//    sees the positions once, the outputs once and the image about once.
//  * direct (everything else): a CTA owns `rows` consecutive rows of one
//    plane and gathers each tap from its row in global memory through the
//    read-only path; in-row offsets are 32-bit. For per-row tables (pass 2)
//    a variant that copied each row's tapped band into shared memory first
//    was timed on the card and was no faster: the gather reads the same
//    sectors, and L1 serves the neighbouring taps.
// Both read positions and write outputs four at a time (float4) where t %
// 4 == 0 and the pointers are 16-byte aligned, one at a time otherwise
// (the direct variant "direct1"), with neighbouring threads on neighbouring
// addresses and streaming cache hints, and keep UNROLL loads in flight per
// thread.
//
// Numerics: the build uses -fmad=false, and the blend is (1 - frac) * t0
// plus frac * t1, two products and then the sum, as in the plain version
// (ops/warp_gather.py::_sample_rows), so the result is bitwise the same in
// every variant.
//
// The kernels allocate nothing; they run on the caller's stream. The C entry
// point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int VEC = 4;  // outputs a thread reads and writes at once
constexpr int UNROLL = 4;  // loads a thread keeps in flight
// the most shared memory a staged row may take: the 48 KB a block gets
// without an opt-in; four CTAs share an SM (64 registers a thread), and four
// such rows fit its shared memory
constexpr int STAGE_BYTES_MAX = 48 * 1024;
constexpr int MAX_GRID_Y = 65535;
constexpr int MAX_ITEMS = 1 << 30;  // items a CTA may walk (32-bit indices)


enum Mode { STAGED = 0, DIRECT4 = 1, DIRECT1 = 2 };

// taps from the staged copy of a row (tap i lives at s[i - off])
struct SharedTaps {
  const float* s;
  int off;
  __device__ __forceinline__ float operator()(int i) const { return s[i - off]; }
};

// taps straight from a row in global memory
struct GlobalTaps {
  const float* g;
  __device__ __forceinline__ float operator()(int i) const {
    return __ldg(g + i);
  }
};

template <bool LINEAR, class Taps>
__device__ __forceinline__ float sample(const Taps& tap, float p, int lo,
                                        int hi) {
  if (LINEAR) {
    const float p0f = floorf(p);
    const float frac = p - p0f;
    const int p0 = min(max((int)p0f, lo), hi);
    const int p1 = min(p0 + 1, hi);
    const float a = (1.0f - frac) * tap(p0);
    const float b = frac * tap(p1);
    return a + b;
  }
  return tap(min(max((int)floorf(p + 0.5f), lo), hi));
}

template <bool LINEAR, class Taps>
__device__ __forceinline__ float4 sample(const Taps& tap, float4 p, int lo,
                                         int hi) {
  return make_float4(sample<LINEAR>(tap, p.x, lo, hi),
                     sample<LINEAR>(tap, p.y, lo, hi),
                     sample<LINEAR>(tap, p.z, lo, hi),
                     sample<LINEAR>(tap, p.w, lo, hi));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Staged: CTA (blockIdx.x = table row r, blockIdx.y = plane group). Item j
// of the CTA is float4 q = j % t4 of plane n0 + j / t4, so a warp's loads and
// stores are 512 consecutive bytes of one (plane, row).
template <bool LINEAR>
__global__ void __launch_bounds__(NTHREADS, 4)
interp_rows_staged_kernel(const float* __restrict__ tables,
                          const float4* __restrict__ pos,
                          float4* __restrict__ out, int n, int r_len, int t4,
                          int width, int lo, int hi, int group) {
  extern __shared__ __align__(16) float s_row[];
  const int r = blockIdx.x;
  const int n0 = blockIdx.y * group;
  const int items = min(group, n - n0) * t4;
  const int s_lo = lo & ~3;
  const int n_stage = hi + 1 - s_lo;
  const float* row = tables + (int64_t)r * width + s_lo;
  if ((width & 3) == 0 && ((uintptr_t)tables & 15) == 0) {
    // 16-byte chunks; the last may run past hi, never past the row (width
    // and s_lo are multiples of 4), and the plan sizes s_row for it
    for (int i = threadIdx.x; 4 * i < n_stage; i += NTHREADS)
      cp_async16(s_row + 4 * i, row + 4 * i);
    cp_async_wait_all();
  } else {
    for (int i = threadIdx.x; i < n_stage; i += NTHREADS) s_row[i] = row[i];
  }
  __syncthreads();
  const SharedTaps tap{s_row, s_lo};
  const int64_t plane = (int64_t)r_len * t4;  // float4s between planes
  const int64_t base = ((int64_t)n0 * r_len + r) * t4;
  for (int j0 = threadIdx.x; j0 < items; j0 += NTHREADS * UNROLL) {
    float4 p[UNROLL];
    int64_t at[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * NTHREADS;
      const int g = j / t4;
      at[u] = base + g * plane + (j - g * t4);
      if (j < items) p[u] = __ldcs(pos + at[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (j0 + u * NTHREADS < items)
        __stcs(out + at[u], sample<LINEAR>(tap, p[u], lo, hi));
  }
}

template <int V>
struct Lanes;
template <>
struct Lanes<4> {
  using T = float4;
};
template <>
struct Lanes<1> {
  using T = float;
};

// Direct: CTA (blockIdx.x = a run of `rows` table rows, blockIdx.y = plane,
// striding over planes past 65535). Item j of the CTA is lane group q = j %
// tq of row r0 + j / tq.
template <bool LINEAR, int V>
__global__ void __launch_bounds__(NTHREADS, 4)
interp_rows_direct_kernel(const float* __restrict__ tables,
                          const float* __restrict__ pos,
                          float* __restrict__ out, int n, int r_len, int t_len,
                          int width, int share, int lo, int hi, int rows) {
  using T = typename Lanes<V>::T;
  const int r0 = blockIdx.x * rows;
  const int tq = t_len / V;
  const int items = min(rows, r_len - r0) * tq;
  for (int nn = blockIdx.y; nn < n; nn += gridDim.y) {
    const int64_t row0 = (int64_t)nn * r_len + r0;
    const float* tab0 =
        tables + ((share ? 0 : (int64_t)nn * r_len) + r0) * (int64_t)width;
    for (int j0 = threadIdx.x; j0 < items; j0 += NTHREADS * UNROLL) {
      T p[UNROLL];
      int lr[UNROLL];
      int64_t at[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * NTHREADS;
        lr[u] = j / tq;
        at[u] = (row0 + lr[u]) * t_len + (int64_t)(j - lr[u] * tq) * V;
        if (j < items) p[u] = __ldcs(reinterpret_cast<const T*>(pos + at[u]));
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (j0 + u * NTHREADS < items) {
          const GlobalTaps tap{tab0 + (int64_t)lr[u] * width};
          __stcs(reinterpret_cast<T*>(out + at[u]),
                 sample<LINEAR>(tap, p[u], lo, hi));
        }
    }
  }
}

const void* const KERNELS[] = {
    (const void*)interp_rows_staged_kernel<true>,
    (const void*)interp_rows_staged_kernel<false>,
    (const void*)interp_rows_direct_kernel<true, 4>,
    (const void*)interp_rows_direct_kernel<false, 4>,
    (const void*)interp_rows_direct_kernel<true, 1>,
    (const void*)interp_rows_direct_kernel<false, 1>,
};

}  // namespace

// The launch constants ops/warp_gather.py mirrors: 0 threads per CTA, 1 the
// float4 width, 2 the staged row's shared-memory limit, 3 the most registers
// and 4 the most static shared memory over the compiled variants (negative:
// the query failed).
extern "C" int vt_interp_tiling(int which) {
  if (which == 0) return NTHREADS;
  if (which == 1) return VEC;
  if (which == 2) return STAGE_BYTES_MAX;
  if (which != 3 && which != 4) return -1;
  int most = 0;
  for (const void* k : KERNELS) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, k) != cudaSuccess) return -1;
    most = max(most, which == 3 ? attr.numRegs : (int)attr.sharedSizeBytes);
  }
  return most;
}

// mode: 0 staged, 1 direct with float4 positions and outputs, 2 direct one
// at a time; group: planes per CTA (staged); rows: table rows per CTA
// (direct). Refuses (cudaErrorInvalidValue) a plan the kernel cannot take.
extern "C" int vt_interp_rows(const float* tables, const float* pos,
                              float* out, int n, int r, int t, int width,
                              int share, int linear, int lo, int hi, int mode,
                              int group, int rows, void* stream) {
  if (n <= 0 || r <= 0 || t <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  if (lo < 0 || lo > hi || hi >= width) return (int)cudaErrorInvalidValue;
  const bool vec_ok = t % VEC == 0 && ((uintptr_t)pos & 15) == 0 &&
                      ((uintptr_t)out & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == STAGED) {
    const int s_lo = lo & ~3;
    const size_t smem = (size_t)((hi + 1 - s_lo + 3) / 4) * 16;
    const int64_t gy = ((int64_t)n + group - 1) / max(group, 1);
    if (!share || !vec_ok || group < 1 || smem > STAGE_BYTES_MAX ||
        gy > MAX_GRID_Y || (int64_t)group * (t / VEC) > MAX_ITEMS)
      return (int)cudaErrorInvalidValue;
    const dim3 grid(r, (unsigned)gy);
    const float4* p4 = reinterpret_cast<const float4*>(pos);
    float4* o4 = reinterpret_cast<float4*>(out);
    if (linear)
      interp_rows_staged_kernel<true><<<grid, NTHREADS, smem, s>>>(
          tables, p4, o4, n, r, t / VEC, width, lo, hi, group);
    else
      interp_rows_staged_kernel<false><<<grid, NTHREADS, smem, s>>>(
          tables, p4, o4, n, r, t / VEC, width, lo, hi, group);
    return (int)cudaGetLastError();
  }
  if ((mode != DIRECT4 && mode != DIRECT1) || (mode == DIRECT4 && !vec_ok) ||
      rows < 1 || (int64_t)rows * (mode == DIRECT4 ? t / VEC : t) > MAX_ITEMS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((r + rows - 1) / rows, min(n, MAX_GRID_Y));
  if (mode == DIRECT4) {
    if (linear)
      interp_rows_direct_kernel<true, 4><<<grid, NTHREADS, 0, s>>>(
          tables, pos, out, n, r, t, width, share, lo, hi, rows);
    else
      interp_rows_direct_kernel<false, 4><<<grid, NTHREADS, 0, s>>>(
          tables, pos, out, n, r, t, width, share, lo, hi, rows);
  } else {
    if (linear)
      interp_rows_direct_kernel<true, 1><<<grid, NTHREADS, 0, s>>>(
          tables, pos, out, n, r, t, width, share, lo, hi, rows);
    else
      interp_rows_direct_kernel<false, 1><<<grid, NTHREADS, 0, s>>>(
          tables, pos, out, n, r, t, width, share, lo, hi, rows);
  }
  return (int)cudaGetLastError();
}
