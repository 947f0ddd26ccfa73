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
// What bounds it on the card: the state is 8 bytes per voxel and every view
// reads and writes it (2.1 GB per view at 512^3), so it is bound by memory
// traffic, with two IEEE divisions per voxel and view behind that. The image
// stack (36 x 240 x 320 x 4 B = 11 MB) stays in L2 across the launch.
// What the design does about it: one CTA per (z-plane, 32-wide x-tile)
// folds every view in one launch, so the per-view state round trip stays on
// chip (L2) for the CTAs in flight; the pass-1 intermediate lives in shared
// memory and never reaches device memory; a warp owns 32 consecutive x, so
// every state access is one coalesced 128-byte line.
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
// own voxel, so the output state may be the input state (an update in
// place, which the z-chunked carve uses at 1024^3).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;         // x-tile width: one warp
constexpr int NTHREADS = 256;  // 8 warps
constexpr int NCOEF = 16;      // R row-major 9, t 3, fx fy cx cy
constexpr int NCOEF_ORTHO = 20;  // + the real camera-z row rz0 rz1 rz2 rt

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
  int linear;          // 1 = bilinear taps, 0 = nearest (half up)
  int rule;            // 0 = MAX, 1 = WEIGHTED_AVERAGE
  int outside;         // 0 = NONE (skip), 1 = MAX (per-image max)
  int cap;             // voxel_max_update_num
  int use_trunc;
  float trunc_thresh;  // -1 or -band (metric)
  float weight;
  int ortho;  // 1 = behind mask from the real camera-z row (coef 16..19)
};

__device__ __forceinline__ float clip_finite(float x, float hi) {
  // clip(nan_to_num(x, nan=0), -1, hi); +-inf clip to the bounds
  if (x != x) x = 0.0f;
  return fminf(fmaxf(x, -1.0f), hi);
}

__device__ __forceinline__ float safe_denom(float x) {
  return fabsf(x) < 1e-12f ? 1e-12f : x;
}

// torch.maximum / jnp.maximum: NaN propagates
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// Sample a row of `stride`-spaced values at `pos`: floor + clamp to
// [lo, hi], second linear tap at min(p0 + 1, hi); NN rounds half up.
// `clamp_img` applies the -1e6 sentinel clamp to raw image values.
__device__ __forceinline__ float sample(const float* row, int stride,
                                        float pos, int lo, int hi, int linear,
                                        bool clamp_img) {
  if (linear) {
    float p0f = floorf(pos);
    float frac = pos - p0f;
    int p0 = min(max((int)p0f, lo), hi);
    int p1 = min(p0 + 1, hi);
    float t0 = row[p0 * stride];
    float t1 = row[p1 * stride];
    if (clamp_img) {
      t0 = fmaxf(t0, -1e6f);
      t1 = fmaxf(t1, -1e6f);
    }
    float a = (1.0f - frac) * t0;
    float b = frac * t1;
    return a + b;
  }
  int p0 = min(max((int)floorf(pos + 0.5f), lo), hi);
  float t0 = row[p0 * stride];
  return clamp_img ? fmaxf(t0, -1e6f) : t0;
}

__global__ void __launch_bounds__(NTHREADS)
warp_fused_kernel(WarpArgs a) {
  extern __shared__ float inter[];  // [h][TX] pass-1 intermediate
  const int z = blockIdx.y;
  const int xb = blockIdx.x * TX;
  const float czk = a.cz[z];
  const float fh = (float)a.h;
  const float fw = (float)a.w;
  const int64_t plane = (int64_t)z * a.ny * a.nx;
  const int ncoef = a.ortho ? NCOEF_ORTHO : NCOEF;

  for (int v = 0; v < a.n_views; ++v) {
    const float* c = a.coef + (int64_t)v * ncoef;
    const float r00 = c[0], r01 = c[1], r02 = c[2];
    const float r10 = c[3], r11 = c[4], r12 = c[5];
    const float r20 = c[6], r21 = c[7], r22 = c[8];
    const float t0 = c[9], t1 = c[10], t2 = c[11];
    const float fx = c[12], fy = c[13], cxp = c[14], cyp = c[15];
    const float rz0 = a.ortho ? c[16] : 0.0f, rz1 = a.ortho ? c[17] : 0.0f;
    const float rt = a.ortho ? c[19] : 0.0f;
    const float max_i = a.vmax[v];
    float m;
    m = r02 * czk;
    const float a0 = m + t0;
    m = r12 * czk;
    const float b0 = m + t1;
    m = r22 * czk;
    const float c0 = m + t2;
    const float zk = a.ortho ? c[18] * czk : 0.0f;  // rz2 * z
    const float* img = a.imgs + (int64_t)v * a.h * a.w;

    // ---- pass 1: inter[r][tx] = image row r sampled at u_eq ----
    for (int idx = threadIdx.x; idx < a.h * TX; idx += NTHREADS) {
      const int r = idx / TX;
      const int x = xb + idx % TX;
      float val = 0.0f;
      if (x < a.nx) {
        const float xr = a.cx[x];
        const float vbar = (float)r - cyp;
        const float denom = vbar * r21 - fy * r11;
        const float sd = safe_denom(denom);
        const float ny_ = fy * (b0 + r10 * xr);
        const float nd_ = vbar * (c0 + r20 * xr);
        const float y_star = (ny_ - nd_) / sd;
        const float s_star = (c0 + r20 * xr) + r21 * y_star;
        const float ss = safe_denom(s_star);
        const float num = fx * ((a0 + r00 * xr) + r01 * y_star);
        const float u_eq = clip_finite(num / ss + cxp, fw);
        val = sample(img + (int64_t)r * a.w, 1, u_eq, a.x0, a.x1, a.linear,
                     true);
      }
      inter[idx] = val;
    }
    __syncthreads();

    // ---- pass 2 + masks + update, one voxel per (y, tx) ----
    const float* src_sdf = v == 0 ? a.sdf_in : a.sdf_out;
    const int* src_un = v == 0 ? a.un_in : a.un_out;
    for (int idx = threadIdx.x; idx < a.ny * TX; idx += NTHREADS) {
      const int y = idx / TX;
      const int tx = idx % TX;
      const int x = xb + tx;
      if (x >= a.nx) continue;
      const float xc = a.cx[x];
      const float yc = a.cy[y];
      const float s_ = (c0 + r20 * xc) + r21 * yc;
      const float q_ = (b0 + r10 * xc) + r11 * yc;
      const float p_ = (a0 + r00 * xc) + r01 * yc;
      const float v_star = (fy * q_) / s_ + cyp;
      const float u_star = (fx * p_) / s_ + cxp;
      const float v_pos = clip_finite(v_star, fh);
      float dist = sample(inter + tx, TX, v_pos, a.y0, a.y1, a.linear, false);

      bool behind = s_ < 0.0f;
      if (a.ortho) {
        const float zy = rz1 * yc;
        const float zx = rz0 * xc;
        const float z_cam = ((zk + zy) + zx) + rt;
        behind = behind || (z_cam < 0.0f);
      }
      // non-finite (inf or NaN) projected coordinates
      const bool bad =
          !(fabsf(u_star) <= FLT_MAX && fabsf(v_star) <= FLT_MAX);
      const bool outside = (u_star < (float)a.x0) || (v_star < (float)a.y0) ||
                           (u_star > (float)a.x1) || (v_star > (float)a.y1);
      bool skip = behind || bad;
      if (a.outside == 0) {
        skip = skip || outside;
      } else if (outside) {
        dist = max_i;
      }

      const int64_t off = plane + (int64_t)y * a.nx + x;
      const float sdf = src_sdf[off];
      const int un = src_un[off];
      skip = skip || (un > a.cap);
      if (a.use_trunc) skip = skip || (dist < a.trunc_thresh);
      const bool first = un < 1;
      float new_sdf;
      int new_un;
      if (a.rule == 0) {
        const bool improved = dist > sdf;
        new_sdf = first ? dist : nan_max(sdf, dist);
        new_un = un + ((first || improved) ? 1 : 0);
      } else {
        const float wt = a.weight;
        const float n = (float)un;
        const float inv_denom = 1.0f / (wt * (n + 1.0f));
        const float lhs = (wt * n) * sdf;
        const float rhs = wt * dist;
        const float avg = (lhs + rhs) * inv_denom;
        new_sdf = first ? dist : avg;
        new_un = un + 1;
      }
      a.sdf_out[off] = skip ? sdf : new_sdf;
      a.un_out[off] = skip ? un : new_un;
    }
    __syncthreads();  // the next view overwrites `inter`
  }
}

}  // namespace

extern "C" int vt_warp_fuse_planes(
    const float* sdf_in, const int* un_in, float* sdf_out, int* un_out,
    const float* cx, const float* cy, const float* cz, const float* coef,
    const float* vmax, const float* imgs, int nz, int ny, int nx, int n_views,
    int h, int w, int x0, int y0, int x1, int y1, int linear, int rule,
    int outside, int cap, int use_trunc, float trunc_thresh, float weight,
    int ortho, void* stream) {
  if (nz <= 0 || ny <= 0 || nx <= 0 || n_views <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  if (nz > 65535) return (int)cudaErrorInvalidValue;
  WarpArgs a{sdf_in, un_in, sdf_out, un_out, cx, cy, cz, coef, vmax, imgs,
             nz, ny, nx, n_views, h, w, x0, y0, x1, y1, linear, rule,
             outside, cap, use_trunc, trunc_thresh, weight, ortho};
  const size_t smem = (size_t)h * TX * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      warp_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nx + TX - 1) / TX, nz);
  warp_fused_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
