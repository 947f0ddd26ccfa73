// Fused multi-view warp fusion for Hopper (sm_90a).
//
// Replaces the TPU kernel vacancy_tpu/ops/warp_fused.py::_warp_fused_kernel
// (launched by warp_fuse_planes). It computes, for every z-plane and every
// view in order, the two-pass warp of ops/warp_fused.warp_fuse_planes_plain:
//   pass 1: each image row v resampled at the closed-form u_eq(x, v) of the
//           plane's homography -> an (h x TX) intermediate per x-tile;
//   pass 2: that intermediate resampled along v at each voxel's exact v*;
//   then the behind / non-finite / outside masks and apply_view_update
//   (MAX or weighted average, cap, truncation skip, first touch).
//
// What bounds it on the card: operations, by instruction throughput. A voxel
// and view cost some 105 instructions, a pass-1 sample some 80: the build
// forbids FMA contraction, so a multiply-add is two instructions; an IEEE
// division is a reciprocal approximation, five fused refinement steps, a
// range check and a branch to a slow path (8 instructions, 10 with the
// pair that brackets the branch; 2 divisions per voxel and view, 2 per
// sample); compares, selects, min/max and integer work run at half the
// rate of multiplies and adds. The state (8 bytes a voxel) and the image
// stack (100 x 240 x 320 x 4 B = 31 MB, resident in L2) are small beside
// that: a build that only moved the state into registers, two CTAs per
// SM, took as long as the kernel that streamed it once per view.
// What the design does about it:
//   - a CTA owns (z-plane, 32-wide x-tile, 64-row y-tile) and each thread
//     8 voxels of one x, whose sdf and update_num it loads ONCE before the
//     view loop, folds in registers, and stores ONCE after the last view:
//     the view loop moves no state through device memory. Eight voxels a
//     thread fit 64 registers, so four CTAs (32 warps) share an SM: each
//     division is a dependent chain, and more warps in flight hide it
//     better than more voxels a thread (16 voxels, two CTAs: 1.3 x slower);
//   - per view the threads first compute their voxels' v*, keep what the
//     view does to each voxel as one code (the first tapped row, or skip,
//     or take the image's max), and reduce, over the CTA, the band of image
//     rows that the voxels will tap; pass 1 then runs over that band only.
//     A row's pass-1 values do not depend on who asks, so the band is
//     bitwise safe, and a y-tile that maps wholly outside the image does no
//     pass 1 at all. The band lives in shared memory, `inter_rows` rows at
//     a time: a band taller than that is walked in row chunks that overlap
//     by the one row a linear tap pair can straddle;
//   - a voxel that taps lies inside the ROI, so the plain version's clip of
//     v* and clamp of its floor are identities there and are left out;
//     the masks are one chain of compares;
//   - terms that depend on x only ((a0 + r00 x) and its two siblings) are
//     computed once per thread and view, not once per voxel, in the plain
//     version's operation order;
//   - the launch's uniform choices (sampler, rule, outside, ortho) are
//     template parameters: 16 kernels, no branch on them per voxel;
//   - the view's coefficients reach shared memory once per CTA and view,
//     double-buffered so the load of view v + 1 hides behind pass 1 of v;
//   - a warp owns 32 consecutive x (threadIdx.x), so every state access is
//     one coalesced 128-byte line, and the intermediate's column of a lane
//     is its own shared-memory bank.
//
// Orthographic views (the TPU kernel's `ortho` flag): the caller passes the
// synthetic homography (third row (0, 0, 0, 1), unit focal length, zero
// principal point), whose divisor S is identically 1, plus each view's real
// camera-z row as four more coefficients; the behind-camera mask is then
// z_cam < 0 with z_cam summed in the two-pass engine's order,
// ((rz2*z + rz1*y) + rz0*x) + rt (ops/fusion_warp.warp_fold); S < 0 never
// fires there.
//
// Numerics: the build uses -fmad=false and IEEE division, and every
// expression keeps the operation order of ops/warp_fused.py and
// ops/fusion.py, so the result is bitwise the plain PyTorch version's.
//
// The kernel allocates nothing; it runs on the caller's stream. The C entry
// point returns the launch's cudaError_t. A thread reads and writes only its
// own voxels, and reads them all before it writes any, so the output state
// may be the input state (an update in place, which the z-chunked carve
// uses at 1024^3).

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;             // x-tile width: one warp
constexpr int NWARPS = 8;          // threadIdx.y
constexpr int VPT = 8;             // voxels (rows of one x) per thread
constexpr int TY = NWARPS * VPT;   // y-tile height
constexpr int MIN_CTAS = 4;        // CTAs per SM the register budget allows
constexpr int NCOEF = 16;          // R row-major 9, t 3, fx fy cx cy
constexpr int NCOEF_ORTHO = 20;    // + the real camera-z row rz0 rz1 rz2 rt
constexpr int NCS = 24;            // shared slots per view; the last: vmax

struct WarpArgs {
  const float* sdf_in;
  const int* un_in;
  float* sdf_out;
  int* un_out;
  const float* cx;
  const float* cy;
  const float* cz;
  const float* coef;  // [V, 16], or [V, 20] with ortho
  const float* vmax;  // [V] per-image max of the raw images
  const float* imgs;  // [V, H, W] raw images (clamped at sampling)
  int nz, ny, nx, n_views, h, w;
  int x0, y0, x1, y1;  // inclusive ROI
  int cap;             // voxel_max_update_num
  float trunc_thresh;  // -1 or -band (metric); -inf without truncation
  float weight;
  int inter_rows;  // rows of the pass-1 intermediate held in shared memory
};

__device__ __forceinline__ float clip_finite(float x, float hi) {
  // clip(nan_to_num(x, nan=0), -1, hi); +-inf clip to the bounds
  if (x != x) x = 0.0f;
  return fminf(fmaxf(x, -1.0f), hi);
}

__device__ __forceinline__ float safe_denom(float x) {
  return fabsf(x) < 1e-12f ? 1e-12f : x;
}

// Sample the image row that starts at element `row` of `img` at `pos`:
// floor + clamp to [lo, hi], second linear tap at min(p0 + 1, hi); NN
// rounds half up; raw image values take the -1e6 sentinel clamp. An image
// holds fewer than 2^32 pixels, so a tap's offset is one 32-bit add.
template <bool LINEAR>
__device__ __forceinline__ float sample_image(const float* img, unsigned row,
                                              float pos, int lo, int hi) {
  if (LINEAR) {
    float p0f = floorf(pos);
    float frac = pos - p0f;
    int p0 = min(max((int)p0f, lo), hi);
    int p1 = min(p0 + 1, hi);
    float t0 = fmaxf(img[row + (unsigned)p0], -1e6f);
    float t1 = fmaxf(img[row + (unsigned)p1], -1e6f);
    float a = (1.0f - frac) * t0;
    float b = frac * t1;
    return a + b;
  }
  int p0 = min(max((int)floorf(pos + 0.5f), lo), hi);
  return fmaxf(img[row + (unsigned)p0], -1e6f);
}

// The pass-1 intermediate is read and written at 32-bit shared-memory
// addresses computed once per thread: one shift-add per access.
__device__ __forceinline__ float load_shared(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void store_shared(unsigned addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" : : "r"(addr), "f"(v) : "memory");
}

// What a view does to one voxel, decided before pass 1: the first image
// row its sample taps (>= 0), or one of two negative codes.
constexpr int USE_MAX = -1;  // outside the image: takes the image's max
constexpr int SKIP = -2;     // behind, non-finite, or outside with NONE

// LINEAR: bilinear taps, else nearest (half up); WAVG: the weighted
// average rule, else MAX; OUT_MAX: a voxel outside the image takes the
// image's max, else it is skipped; ORTHO: the behind mask also reads the
// real camera-z row (coefficients 16..19)
template <bool LINEAR, bool WAVG, bool OUT_MAX, bool ORTHO>
__global__ void __launch_bounds__(TX * NWARPS, MIN_CTAS)
warp_fused_kernel(WarpArgs a) {
  extern __shared__ float inter[];  // [inter_rows][TX] pass-1 intermediate
  __shared__ float cs[2][NCS];      // the view's coefficients, two buffers
  __shared__ int red_lo[NWARPS], red_hi[NWARPS];
  __shared__ float cys[TY];

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * TX + lane;
  const int z = blockIdx.y;
  const int x = blockIdx.x * TX + lane;
  const int yb = blockIdx.z * TY;
  const int ncoef = ORTHO ? NCOEF_ORTHO : NCOEF;
  const bool x_ok = x < a.nx;
  // a voxel past the grid's edge projects to NaN and so skips every view
  const float xc = x_ok ? a.cx[x] : nanf("");
  const float czk = a.cz[z];
  const float fw = (float)a.w;
  const float fx0 = (float)a.x0, fx1 = (float)a.x1;
  const float fy0 = (float)a.y0, fy1 = (float)a.y1;
  const unsigned full = 0xffffffffu;
  // rows a chunk of the band advances by: linear tap pairs straddle one
  const int step = LINEAR ? max(a.inter_rows - 1, 1) : a.inter_rows;
  // this lane's column of the intermediate; a row is TX floats further
  const unsigned mine =
      (unsigned)__cvta_generic_to_shared(inter) + (unsigned)lane * 4u;
  constexpr unsigned ROW_BYTES = TX * sizeof(float);

  if (tid < TY) cys[tid] = yb + tid < a.ny ? a.cy[yb + tid] : nanf("");
  if (tid < ncoef) cs[0][tid] = a.coef[tid];
  if (tid == NCS - 1) cs[0][tid] = a.vmax[0];

  // ---- the state: one read before the view loop ----
  float sdf[VPT];
  int un[VPT];
  const int64_t col = (int64_t)z * a.ny * a.nx + x;
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    const int y = yb + r * NWARPS + warp;
    sdf[r] = 0.0f;
    un[r] = 0;
    if (x_ok && y < a.ny) {
      const int64_t off = col + (int64_t)y * a.nx;
      sdf[r] = a.sdf_in[off];
      un[r] = a.un_in[off];
    }
  }
  __syncthreads();

  for (int v = 0; v < a.n_views; ++v) {
    const float* c = cs[v & 1];
    const float r01 = c[1], r11 = c[4], r21 = c[7];
    const float fx = c[12], fy = c[13], cxp = c[14], cyp = c[15];
    const float max_i = c[NCS - 1];
    float m;
    m = c[2] * czk;
    const float a0 = m + c[9];
    m = c[5] * czk;
    const float b0 = m + c[10];
    m = c[8] * czk;
    const float c0 = m + c[11];
    // the x-only terms of pass 1 and pass 2, once per thread and view
    const float ax = a0 + c[0] * xc;
    const float bx = b0 + c[3] * xc;
    const float cxs = c0 + c[6] * xc;
    float zkx = 0.0f, rz1 = 0.0f, rt = 0.0f, zx = 0.0f;
    if (ORTHO) {
      zkx = c[18] * czk;  // rz2 * z
      rz1 = c[17];
      zx = c[16] * xc;
      rt = c[19];
    }

    // ---- every voxel's v*, its code, and the band of tapped rows. A
    // voxel that taps lies inside the ROI, y0 <= v* <= y1, so the plain
    // version's clip of v* to [-1, h] and the clamp of its floor to
    // [y0, y1] change nothing there (round-half-up can reach y1 + 1) ----
    int code[VPT];
    float frac[VPT];
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int r = 0; r < VPT; ++r) {
      const float yc = cys[r * NWARPS + warp];
      const float s_ = cxs + r21 * yc;
      const float q_ = bx + r11 * yc;
      const float p_ = ax + r01 * yc;
      const float v_star = (fy * q_) / s_ + cyp;
      const float u_star = (fx * p_) / s_ + cxp;
      bool gone = s_ < 0.0f;  // behind the camera
      if (ORTHO) {
        const float zy = rz1 * yc;
        const float z_cam = ((zkx + zy) + zx) + rt;
        gone = gone || (z_cam < 0.0f);
      }
      // false for NaN and +-inf as well as outside the ROI
      const bool inside = u_star >= fx0 && u_star <= fx1 && v_star >= fy0 &&
                          v_star <= fy1;
      int row;
      if (LINEAR) {
        const float p0f = floorf(v_star);
        frac[r] = v_star - p0f;
        row = (int)p0f;
      } else {
        row = min((int)floorf(v_star + 0.5f), a.y1);
      }
      if (OUT_MAX) {
        // non-finite (inf or NaN) projected coordinates skip
        gone = gone ||
               !(fabsf(u_star) <= FLT_MAX && fabsf(v_star) <= FLT_MAX);
        code[r] = gone ? SKIP : (inside ? row : USE_MAX);
      } else {
        code[r] = (gone || !inside) ? SKIP : row;
      }
      // the negative codes are the largest unsigned and the least signed
      lo = (int)min((unsigned)lo, (unsigned)code[r]);
      hi = max(hi, code[r]);
    }
    lo = (int)__reduce_min_sync(full, (unsigned)lo);
    hi = __reduce_max_sync(full, hi);
    if (lane == 0) {
      red_lo[warp] = lo;
      red_hi[warp] = hi;
    }
    __syncthreads();
    // the next view's coefficients: its buffer was last read in view v - 1
    if (warp == 0 && v + 1 < a.n_views) {
      if (lane < ncoef)
        cs[(v + 1) & 1][lane] = a.coef[(int64_t)(v + 1) * ncoef + lane];
      if (lane == NCS - 1) cs[(v + 1) & 1][lane] = a.vmax[v + 1];
    }
    unsigned ulo = (unsigned)red_lo[0];
    int pmax = red_hi[0];
#pragma unroll
    for (int q = 1; q < NWARPS; ++q) {
      ulo = min(ulo, (unsigned)red_lo[q]);
      pmax = max(pmax, red_hi[q]);
    }
    int blo = (int)ulo;
    int bhi;  // last row of the band: a linear tap pair reaches p0 + 1
    if (pmax < 0) {
      if (!OUT_MAX || pmax == SKIP) {
        __syncthreads();  // the coefficients just stored; red_lo, red_hi
        continue;         // the view leaves every voxel of the CTA alone
      }
      blo = 0;  // no voxel taps, some take the image's max
      bhi = -1;
    } else {
      bhi = LINEAR ? min(pmax + 1, a.y1) : pmax;
    }
    const float* img = a.imgs + (int64_t)v * a.h * a.w;
    const unsigned width = (unsigned)a.w;

    for (int rc = blo;; rc += step) {
      // ---- pass 1: inter[row - rc][lane] = image row sampled at u_eq ----
      const int rend = min(rc + a.inter_rows - 1, bhi);
      float frow = (float)(rc + warp);
      for (int row = rc + warp; row <= rend; row += NWARPS) {
        float val = 0.0f;
        if (x_ok) {
          const float vbar = frow - cyp;
          const float denom = vbar * r21 - fy * r11;
          const float sd = safe_denom(denom);
          const float ny_ = fy * bx;
          const float nd_ = vbar * cxs;
          const float y_star = (ny_ - nd_) / sd;
          const float s_star = cxs + r21 * y_star;
          const float ss = safe_denom(s_star);
          const float num = fx * (ax + r01 * y_star);
          const float u_eq = clip_finite(num / ss + cxp, fw);
          val = sample_image<LINEAR>(img, (unsigned)row * width, u_eq, a.x0,
                                     a.x1);
        }
        store_shared(mine + (unsigned)(row - rc) * ROW_BYTES, val);
        frow += (float)NWARPS;  // exact: rows are small integers
      }
      __syncthreads();

      // ---- pass 2 + update, on the voxels whose taps lie in this chunk;
      //      the state stays in registers ----
      const bool first_chunk = rc == blo;
#pragma unroll
      for (int r = 0; r < VPT; ++r) {
        const int cd = code[r];
        float dist;
        if (OUT_MAX && cd == USE_MAX) {
          if (!first_chunk) continue;
          dist = max_i;
        } else {
          // SKIP and rows of other chunks fall outside [0, step)
          const int rel = cd - rc;
          if ((unsigned)rel >= (unsigned)step) continue;
          const float t0 = load_shared(mine + (unsigned)rel * ROW_BYTES);
          if (LINEAR) {
            const float t1 = load_shared(
                mine + (unsigned)(min(cd + 1, a.y1) - rc) * ROW_BYTES);
            const float wa = (1.0f - frac[r]) * t0;
            const float wb = frac[r] * t1;
            dist = wa + wb;
          } else {
            dist = t0;
          }
        }
        const float s = sdf[r];
        const int n_up = un[r];
        // without truncation the threshold is -inf: no sample lies below
        if (n_up > a.cap || dist < a.trunc_thresh) continue;
        const bool first = n_up < 1;
        if (!WAVG) {
          // torch.maximum(s, dist), in which NaN propagates: dist unless
          // s is NaN or dist <= s
          const bool improved = dist > s;
          const bool take = !(dist <= s) && s == s;
          sdf[r] = (first || take) ? dist : s;
          un[r] = n_up + ((first || improved) ? 1 : 0);
        } else {
          const float wt = a.weight;
          const float n = (float)n_up;
          const float inv_denom = 1.0f / (wt * (n + 1.0f));
          const float lhs = (wt * n) * s;
          const float rhs = wt * dist;
          const float avg = (lhs + rhs) * inv_denom;
          sdf[r] = first ? dist : avg;
          un[r] = n_up + 1;
        }
      }
      if (rc + step > pmax) break;
      __syncthreads();  // the next chunk overwrites `inter`
    }
    // the next view's pass 1 starts behind its own band barrier, which no
    // thread passes before it has left this view's pass 2
  }

  // ---- the state: one write after the last view ----
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    const int y = yb + r * NWARPS + warp;
    if (x_ok && y < a.ny) {
      const int64_t off = col + (int64_t)y * a.nx;
      a.sdf_out[off] = sdf[r];
      a.un_out[off] = un[r];
    }
  }
}

typedef void (*WarpKernel)(WarpArgs);

constexpr int NVARIANTS = 16;

// the kernel compiled for one set of a launch's uniform choices: bit 3
// linear, 2 weighted average, 1 outside = MAX, 0 orthographic rows
WarpKernel pick_kernel(int variant) {
#define VT_ROW(L, W)                                                  \
  warp_fused_kernel<L, W, false, false>,                              \
      warp_fused_kernel<L, W, false, true>,                           \
      warp_fused_kernel<L, W, true, false>, warp_fused_kernel<L, W, true, true>
  static const WarpKernel table[NVARIANTS] = {
      VT_ROW(false, false), VT_ROW(false, true), VT_ROW(true, false),
      VT_ROW(true, true)};
#undef VT_ROW
  return table[variant];
}

}  // namespace

// The tiling, for the wrapper to hold against its own plan:
// which = 0: x-tile width, 1: y-tile height, 2: threads per CTA,
// 3: static shared memory of the kernel in bytes, 4: registers per thread.
extern "C" int vt_warp_tiling(int which) {
  if (which == 0) return TX;
  if (which == 1) return TY;
  if (which == 2) return TX * NWARPS;
  if (which != 3 && which != 4) return -1;
  int most = 0;  // over the compiled variants
  for (int q = 0; q < NVARIANTS; ++q) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, pick_kernel(q)) != cudaSuccess)
      return -1;
    most = max(most, which == 3 ? (int)attr.sharedSizeBytes : attr.numRegs);
  }
  return most;
}

// CTAs an SM holds at once with `inter_rows` rows of the intermediate in
// shared memory, the least over the compiled variants (negative: the query
// failed).
extern "C" int vt_warp_ctas_per_sm(int inter_rows) {
  const size_t smem = (size_t)inter_rows * TX * sizeof(float);
  int least = INT_MAX;
  for (int q = 0; q < NVARIANTS; ++q) {
    const WarpKernel kernel = pick_kernel(q);
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
      return -1;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, TX * NWARPS, smem) != cudaSuccess)
      return -1;
    least = min(least, n);
  }
  return least;
}

extern "C" int vt_warp_fuse_planes(
    const float* sdf_in, const int* un_in, float* sdf_out, int* un_out,
    const float* cx, const float* cy, const float* cz, const float* coef,
    const float* vmax, const float* imgs, int nz, int ny, int nx, int n_views,
    int h, int w, int x0, int y0, int x1, int y1, int linear, int rule,
    int outside, int cap, int use_trunc, float trunc_thresh, float weight,
    int ortho, int inter_rows, void* stream) {
  if (nz <= 0 || ny <= 0 || nx <= 0 || n_views <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  if (nz > 65535 || (ny + TY - 1) / TY > 65535)
    return (int)cudaErrorInvalidValue;
  // a chunk of the band must hold a linear tap pair
  if (inter_rows < 1 || inter_rows > h || (inter_rows < 2 && h > 1))
    return (int)cudaErrorInvalidValue;
  WarpArgs a{sdf_in, un_in, sdf_out, un_out, cx, cy, cz, coef, vmax, imgs,
             nz, ny, nx, n_views, h, w, x0, y0, x1, y1, cap,
             use_trunc ? trunc_thresh : -INFINITY, weight, inter_rows};
  const size_t smem = (size_t)inter_rows * TX * sizeof(float);
  const WarpKernel kernel = pick_kernel(
      (linear ? 8 : 0) | (rule ? 4 : 0) | (outside ? 2 : 0) | (ortho ? 1 : 0));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nx + TX - 1) / TX, nz, (ny + TY - 1) / TY);
  dim3 block(TX, NWARPS);
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
