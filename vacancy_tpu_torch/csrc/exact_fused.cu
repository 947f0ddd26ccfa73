// The exact engine's fold in one launch for Hopper (sm_90a): kernel E.
//
// Replaces no TPU kernel: the JAX package folds the exact engine's views in
// plain jnp (vacancy_tpu/ops/fusion.py), and so did the port, as some ninety
// eager elementwise, gather and `where` launches a view, each streaming the
// whole grid (ops/fusion.fold_views). It was added because that fold is the
// facade's default path (carve_batch with no engine named: upstream's naive
// kMax carving) and ran at well under 1% of its bound. Launched by
// ops/exact_fused.exact_fold; its plain version is that fold.
//
// For every voxel and every view in order it computes what
// ops/fusion._view_distance and apply_view_update compute:
//   world to camera, ((x r0 + y r1) + z r2) + t per row;
//   pinhole u = (fx / z_cam) * x_cam + cx, v likewise (two IEEE divisions,
//   no shared reciprocal: that would round differently), or ortho u = x_cam,
//   v = y_cam;
//   skips: behind (z_cam < 0), non-finite u or v, outside the ROI (with
//   outside = NONE; with MAX the voxel takes the image's max instead),
//   frozen (update_num > cap), truncated (dist < threshold);
//   nearest (round half up) or bilinear taps clamped to the ROI, the
//   bilinear blend in its written order ((1-a)(1-b) d00 + a(1-b) d10 +
//   (1-a) b d01 + a b d11, summed left to right);
//   the kMax or weighted-average update with first touch.
//
// What bounds it on the card: operations, by instruction throughput. A voxel
// and view cost some 80-110 instructions, 16 of them the two divisions (a
// reciprocal approximation, refinement steps, a range check and a branch to
// a slow path each); the build forbids FMA contraction, so every product
// and sum is an instruction of its own. The state is 8 bytes a voxel, read
// and written once, and the images (36 x 240 x 320 x 4 B = 11 MB at the
// benchmark's shape) stay resident in L2: bytes alone would take a small
// part of the time.
// What the design does about it:
//   - each thread owns VPT voxels of one (y, x) column at consecutive z,
//     loads their sdf and update_num ONCE, folds every view with the state
//     in registers, and stores it ONCE into the output state: the view loop
//     moves no state through device memory (kernel A's design since its
//     redesign). The input state is only read;
//   - the centres come from the grid's three axis arrays (the floats that
//     GridSpec.centers_zyx stacks), read once per thread: no centres tensor;
//   - the (x r0 + y r1) sum of each camera row is the same float for all of
//     a thread's voxels, so it is computed once per thread and view; only
//     z r2, the two sums and the projection remain per voxel;
//   - a warp owns 32 consecutive x (threadIdx.x), so every state access is
//     one coalesced 128-byte line and a warp's taps fall in a few image
//     rows, read through the read-only path (texture filtering is not used:
//     its fixed-point weights are not the blend's floats);
//   - a voxel-view that the plain fold skips does no sampling;
//   - the views' coefficients (w2c rows, f, principal point, the image's
//     max) reach shared memory once per CTA, VCHUNK views at a time, and are
//     read there as float4s;
//   - the launch's uniform choices (sampler, rule, outside policy,
//     truncation, projection) are template parameters: 32 kernels, no
//     branch on them per voxel.
//
// Numerics: built with -fmad=false and IEEE division, and every expression
// keeps the operation order of ops/fusion.py, so the result is bitwise the
// plain fold's.
//
// The kernel allocates nothing and runs on the caller's stream; the C entry
// point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;       // x per warp: one lane each
constexpr int NWARPS = 8;    // threadIdx.y: one row y each
constexpr int VPT = 8;       // consecutive z-planes per thread
constexpr int MIN_CTAS = 4;  // CTAs per SM the register budget allows
constexpr int NC = 20;       // floats per view: see the layout below
constexpr int VCHUNK = 64;   // views whose coefficients a CTA holds at once

// A view's coefficients, five float4s: (r00 r01 r02 t0) (r10 r11 r12 t1)
// (r20 r21 r22 t2) (fx fy cx cy) (max_sdf, unused x3).
struct ExactArgs {
  const float* sdf_in;
  const int* un_in;
  float* sdf_out;
  int* un_out;
  const float* cx;
  const float* cy;
  const float* cz;
  const float4* coef;  // [V, NC / 4]
  const float* imgs;   // [V, H, W]
  int nz, ny, nx, n_views, h, w;
  int x0, y0, x1, y1;  // inclusive ROI, inside the image
  int cap;             // voxel_max_update_num
  float trunc_thresh;  // -1 or -band (metric)
  float weight;
};

// LINEAR: bilinear taps, else nearest (half up); WAVG: the weighted
// average rule, else kMax; OUT_MAX: a voxel outside the ROI takes the
// image's max, else it is skipped; TRUNC: samples below the threshold
// skip; ORTHO: u, v are the camera's x, y
template <bool LINEAR, bool WAVG, bool OUT_MAX, bool TRUNC, bool ORTHO>
__global__ void __launch_bounds__(TX * NWARPS, MIN_CTAS)
exact_fused_kernel(ExactArgs a) {
  __shared__ float4 cs[VCHUNK * NC / 4];

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * TX + lane;
  const int x = blockIdx.x * TX + lane;
  const int y = blockIdx.y * NWARPS + warp;
  const int zb = blockIdx.z * VPT;
  const bool xy_ok = x < a.nx && y < a.ny;
  // a voxel past the grid's edge projects to NaN and so skips every view
  const float xc = x < a.nx ? a.cx[x] : nanf("");
  const float yc = y < a.ny ? a.cy[y] : nanf("");
  const float fx0 = (float)a.x0, fx1 = (float)a.x1;
  const float fy0 = (float)a.y0, fy1 = (float)a.y1;
  const int64_t plane = (int64_t)a.ny * a.nx;
  const int64_t col = (int64_t)zb * plane + (int64_t)y * a.nx + x;
  const int64_t hw = (int64_t)a.h * a.w;

  // ---- the state: one read before the view loop ----
  float zc[VPT], sdf[VPT];
  int un[VPT];
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    const bool ok = xy_ok && zb + r < a.nz;
    zc[r] = ok ? a.cz[zb + r] : nanf("");
    sdf[r] = ok ? a.sdf_in[col + r * plane] : 0.0f;
    un[r] = ok ? a.un_in[col + r * plane] : 0;
  }

  for (int v0 = 0; v0 < a.n_views; v0 += VCHUNK) {
    const int nv = min(VCHUNK, a.n_views - v0);
    __syncthreads();  // every thread has left the previous chunk's views
    for (int i = tid; i < nv * (NC / 4); i += TX * NWARPS)
      cs[i] = a.coef[(int64_t)v0 * (NC / 4) + i];
    __syncthreads();

    for (int j = 0; j < nv; ++j) {
      const float4 q0 = cs[j * 5], q1 = cs[j * 5 + 1], q2 = cs[j * 5 + 2];
      const float* img = a.imgs + (int64_t)(v0 + j) * hw;
      // the x and y terms of each row: the same floats for every voxel of
      // the thread
      float m, n;
      m = xc * q0.x;
      n = yc * q0.y;
      const float p0 = m + n;
      m = xc * q1.x;
      n = yc * q1.y;
      const float p1 = m + n;
      m = xc * q2.x;
      n = yc * q2.y;
      const float p2 = m + n;

#pragma unroll
      for (int r = 0; r < VPT; ++r) {
        m = zc[r] * q2.z;
        const float zcam = (p2 + m) + q2.w;
        m = zc[r] * q0.z;
        const float xcam = (p0 + m) + q0.w;
        m = zc[r] * q1.z;
        const float ycam = (p1 + m) + q1.w;
        float u, v;
        if (ORTHO) {
          u = xcam;
          v = ycam;
        } else {
          const float4 q3 = cs[j * 5 + 3];
          const float su = q3.x / zcam;
          const float sv = q3.y / zcam;
          m = su * xcam;
          u = m + q3.z;
          m = sv * ycam;
          v = m + q3.w;
        }
        // behind the camera, or a non-finite projection (z_cam == 0 among
        // them), or frozen: the view leaves the voxel alone
        const int n_up = un[r];
        if (zcam < 0.0f || !(fabsf(u) <= FLT_MAX && fabsf(v) <= FLT_MAX) ||
            n_up > a.cap)
          continue;
        const bool inside = u >= fx0 && u <= fx1 && v >= fy0 && v <= fy1;
        if (!OUT_MAX && !inside) continue;
        float dist;
        if (OUT_MAX && !inside) {
          dist = cs[j * 5 + 4].x;
        } else if (LINEAR) {
          // inside the ROI the floor taps need no clamp; the +1 taps clamp
          // to its max; the fractions use the floors
          const float fu = floorf(u), fv = floorf(v);
          const int ix0 = (int)fu, iy0 = (int)fv;
          const int ix1 = min(ix0 + 1, a.x1), iy1 = min(iy0 + 1, a.y1);
          const float lu = u - fu, lv = v - fv;
          const int row0 = iy0 * a.w, row1 = iy1 * a.w;
          const float d00 = __ldg(img + row0 + ix0);
          const float d10 = __ldg(img + row0 + ix1);
          const float d01 = __ldg(img + row1 + ix0);
          const float d11 = __ldg(img + row1 + ix1);
          const float ou = 1.0f - lu, ov = 1.0f - lv;
          float w00 = ou * ov, w10 = lu * ov, w01 = ou * lv, w11 = lu * lv;
          w00 = w00 * d00;
          w10 = w10 * d10;
          w01 = w01 * d01;
          w11 = w11 * d11;
          const float s0 = w00 + w10;
          const float s1 = s0 + w01;
          dist = s1 + w11;
        } else {
          // round half up; u >= x0, so only the upper clamp can act
          const int ix = min((int)floorf(u + 0.5f), a.x1);
          const int iy = min((int)floorf(v + 0.5f), a.y1);
          dist = __ldg(img + iy * a.w + ix);
        }
        if (TRUNC && dist < a.trunc_thresh) continue;
        const float s = sdf[r];
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
          const float nf = (float)n_up;
          const float inv_denom = 1.0f / (wt * (nf + 1.0f));
          const float lhs = (wt * nf) * s;
          const float rhs = wt * dist;
          const float avg = (lhs + rhs) * inv_denom;
          sdf[r] = first ? dist : avg;
          un[r] = n_up + 1;
        }
      }
    }
  }

  // ---- the state: one write after the last view ----
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    if (xy_ok && zb + r < a.nz) {
      a.sdf_out[col + r * plane] = sdf[r];
      a.un_out[col + r * plane] = un[r];
    }
  }
}

typedef void (*ExactKernel)(ExactArgs);

constexpr int NVARIANTS = 32;

// the kernel compiled for one set of a launch's uniform choices: bit 4
// linear, 3 weighted average, 2 outside = MAX, 1 truncation, 0 ortho
ExactKernel pick_kernel(int variant) {
#define VT_E4(L, W, O)                                               \
  exact_fused_kernel<L, W, O, false, false>,                         \
      exact_fused_kernel<L, W, O, false, true>,                      \
      exact_fused_kernel<L, W, O, true, false>,                      \
      exact_fused_kernel<L, W, O, true, true>
  static const ExactKernel table[NVARIANTS] = {
      VT_E4(false, false, false), VT_E4(false, false, true),
      VT_E4(false, true, false),  VT_E4(false, true, true),
      VT_E4(true, false, false),  VT_E4(true, false, true),
      VT_E4(true, true, false),   VT_E4(true, true, true)};
#undef VT_E4
  return table[variant];
}

}  // namespace

// The tiling, for the wrapper to hold against its own plan:
// which = 0: x per CTA, 1: y per CTA, 2: z per thread, 3: threads per CTA,
// 4: registers per thread, 5: local (spilled) bytes per thread, each the
// most over the compiled variants; 6: views per coefficient chunk.
extern "C" int vt_exact_tiling(int which) {
  if (which == 0) return TX;
  if (which == 1) return NWARPS;
  if (which == 2) return VPT;
  if (which == 3) return TX * NWARPS;
  if (which == 6) return VCHUNK;
  if (which != 4 && which != 5) return -1;
  int most = 0;
  for (int q = 0; q < NVARIANTS; ++q) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, pick_kernel(q)) != cudaSuccess)
      return -1;
    most = max(most, which == 4 ? attr.numRegs : (int)attr.localSizeBytes);
  }
  return most;
}

// Fold n_views views, in order, into the state: (sdf_in, un_in) are read,
// (sdf_out, un_out) written; they must not overlap the inputs. coef is
// [n_views, 20] floats (16-byte aligned), imgs [n_views, h, w].
extern "C" int vt_exact_fold(const float* sdf_in, const int* un_in,
                             float* sdf_out, int* un_out, const float* cx,
                             const float* cy, const float* cz,
                             const float* coef, const float* imgs, int nz,
                             int ny, int nx, int n_views, int h, int w,
                             int x0, int y0, int x1, int y1, int linear,
                             int rule, int outside, int use_trunc, int ortho,
                             int cap, float trunc_thresh, float weight,
                             void* stream) {
  if (nz <= 0 || ny <= 0 || nx <= 0 || n_views <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)h * w > INT32_MAX || ((uintptr_t)coef & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (x0 < 0 || x0 > x1 || x1 >= w || y0 < 0 || y0 > y1 || y1 >= h)
    return (int)cudaErrorInvalidValue;
  const int64_t gy = (ny + NWARPS - 1) / NWARPS, gz = (nz + VPT - 1) / VPT;
  if (gy > 65535 || gz > 65535) return (int)cudaErrorInvalidValue;
  ExactArgs a{sdf_in, un_in, sdf_out, un_out, cx, cy, cz,
              reinterpret_cast<const float4*>(coef), imgs,
              nz, ny, nx, n_views, h, w, x0, y0, x1, y1, cap,
              trunc_thresh, weight};
  const ExactKernel kernel =
      pick_kernel((linear ? 16 : 0) | (rule ? 8 : 0) | (outside ? 4 : 0) |
                  (use_trunc ? 2 : 0) | (ortho ? 1 : 0));
  dim3 grid((nx + TX - 1) / TX, (unsigned)gy, (unsigned)gz);
  dim3 block(TX, NWARPS);
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
