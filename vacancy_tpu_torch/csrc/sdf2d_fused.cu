// The 2D signed distance fields of a stack of silhouette masks ("S"): the
// L1 distance transform of both classes, the sign, the per-image
// normalisation and the truncation, in three launches.
//
// It replaces no Pallas kernel: vacancy_tpu/ops/sdf2d.py computes this layer
// with XLA scans (jax.lax.cummin along each axis, once for the inside and
// once for the outside), and ops/sdf2d.py's plain version does the same with
// torch.cummin: dozens of launches over full-size float32 temporaries.
//
// What it computes, for each image of a [V, H, W] stack of uint8 (255 =
// foreground) or bool masks and the inclusive ROI (x0, y0, x1, y1): a pixel
// of the ROI gets the city-block distance to the nearest ROI pixel of the
// other class, negated on the foreground, or FLT_MAX (negated likewise) when
// the ROI holds none; a pixel outside the ROI gets 0. Then, as the plain
// version does and in its order and f32 operations: times sdf_scale (metric
// mode), or times 1/abs_max, the image's largest |value|, its reciprocal
// rounded once (min-max mode); then the truncation. Every distance is an
// integer, so the separable transform gives the plain version's minima bit
// for bit in either order of the axes.
//
// Passes:
//   sdf2d_columns_kernel: a CTA per (image, 32 ROI columns), a lane per
//     column, its warps splitting the rows. The CTA reads its columns' mask
//     bytes once (each load one row's 32 bytes) and packs each column into
//     32-row bit words in shared memory. For each pixel a warp finds the
//     nearest row of the other class above and below by bit scans within a
//     word and carries between words. It writes that column distance c >= 1,
//     signed by the pixel's class (int16, -c on the foreground), and zeroes
//     the images' abs_max.
//   sdf2d_rows_kernel: a CTA per ROI row, the transform along the row,
//     D(x) = min_x' |x - x'| + C(x'), where C is 0 on the pixels of the class
//     sought and c elsewhere: two unit-slope min-plus chains (to the
//     background, which the foreground's pixels take, and to the foreground),
//     D = min(forward, backward). A thread runs both over its chunk of the
//     row in shared memory from no carry; the carries between chunks are one
//     prefix and one suffix minimum over the CTA, which the chunk's values take
//     in closed form. It writes D signed by class in place of c, and folds the
//     row's largest |D| into the image's abs_max by an integer atomicMax
//     (exact in any order).
//   sdf2d_finish_kernel: a CTA per image row, elementwise: 0 outside the ROI;
//     inside, the signed distance as f32 (FLT_MAX for the sentinel), then the
//     mode's scale or 1/abs_max, then the truncation; each float written once,
//     four at a time where the row allows.
// Distances are int16 with the sentinel SENT = 32767 for "none". A finite
// distance is at most (H - 1) + (W - 1), so S takes H + W <= 32768; a chain
// through a sentinel reads >= SENT, never below a finite distance, so the
// sentinel takes part in the min-plus arithmetic as that number and every
// result at or above it is the sentinel.
//
// What bounds it on the card: bytes. The masks are read once (1 B a pixel)
// and the images written once (4 B): at 36 x 3840 x 2160, 1.49 GB, 0.446 ms
// at 3.35 TB/s. The design moves 13 B a pixel: the mask once; the int16
// intermediate written by pass 1, read and written in place by pass 2, read by
// pass 3; the float once. Nothing else leaves the chip: the bit columns and the
// row chains live in shared memory and registers. Each pass is one coalesced
// sweep (a warp touches 32 neighbouring pixels of a row per access).
//
// Numerics: the build keeps denormals and IEEE division, so 1/abs_max of an
// image with no pixel of one class (1/FLT_MAX, a denormal) and its products
// round as the plain version's. The C entry point returns cudaError_t.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int SENT = 32767;            // int16 distance: none of the other class
constexpr int INF = 1 << 29;           // a chain's start; the scans' identity
constexpr int MAX_SIDES = 32768;       // h + w that the int16 distances hold
constexpr unsigned FULL = 0xffffffffu;
constexpr int COL_SEGS = 4;            // most warps (row segments) a strip of pass 1
constexpr int ROW_THREADS = 256;       // most threads a CTA of pass 2
constexpr int ROW_PIXELS = 8;          // pass 2: a thread per 8 pixels, up to that
constexpr int FIN_THREADS = 256;       // threads a CTA of pass 3
constexpr int SMEM_DEFAULT = 48 * 1024;  // dynamic shared memory without opt-in
enum Mode { RAW = 0, SCALE = 1, MINMAX = 2 };

// Pass 1. Grid: strips CTAs per image, image-major; block (32, segs): the
// CTA's warps share one strip of 32 columns, warp i taking the words
// [i * per, (i + 1) * per) of its rows. Dynamic shared memory: nwords * 32
// words; lane l keeps its column's word k at [k * 32 + l].
__global__ void __launch_bounds__(32 * COL_SEGS)
sdf2d_columns_kernel(const uint8_t* __restrict__ mask,
                     int16_t* __restrict__ dist, int* __restrict__ abs_max,
                     int strips, int h, int w, int x0, int y0, int rh, int rw,
                     int nwords, int per, int fg) {
  extern __shared__ uint32_t col_words[];
  const int lane = threadIdx.x;
  const int v = blockIdx.x / strips;
  const int strip = blockIdx.x % strips;
  if (strip == 0 && lane == 0 && threadIdx.y == 0) abs_max[v] = 0;
  const int xr = strip * 32 + lane;
  const bool active = xr < rw;
  const int k0 = min(threadIdx.y * per, nwords), k1 = min(k0 + per, nwords);
  uint32_t* words = col_words + lane;
  const uint8_t* src =
      mask + ((size_t)v * h + y0) * w + x0 + (active ? xr : 0);

  for (int k = k0; k < k1; ++k) {
    const int n = min(32, rh - 32 * k);
    const uint8_t* p = src + (size_t)(32 * k) * w;
    uint8_t b[32];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      b[i] = (active && i < n) ? __ldg(p + i * w) : (uint8_t)0;
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      bits |= (uint32_t)(b[i] == fg) << i;  // fg is 1 or 255, never 0
    words[k * 32] = bits;
  }
  __syncthreads();
  if (!active || k0 == k1) return;

  // the last row of each class above the segment: one search back, at most
  // the rows above it
  int last_fg = -INF, last_bg = -INF;
  for (int k = k0 - 1; k >= 0 && last_fg == -INF; --k)
    if (words[k * 32]) last_fg = 32 * k + 31 - __clz(words[k * 32]);
  for (int k = k0 - 1; k >= 0 && last_bg == -INF; --k)  // words above are full
    if (~words[k * 32]) last_bg = 32 * k + 31 - __clz(~words[k * 32]);
  int16_t* dst = dist + (size_t)v * rh * rw + xr;
  int next_fg = INF, next_bg = INF;  // the first row of each class below
  int fg_word = k0, bg_word = k0;    // the words those lie in (nwords: none)
  for (int k = k0; k < k1; ++k) {
    const int base = 32 * k;
    const int n = min(32, rh - base);
    const uint32_t valid = n == 32 ? FULL : (1u << n) - 1u;
    const uint32_t fgb = words[k * 32];  // rows past rh read 0
    const uint32_t bgb = ~fgb & valid;
    if (fg_word <= k) {  // each search moves forward: O(nwords) a column
      next_fg = INF;
      for (fg_word = k + 1; fg_word < nwords; ++fg_word) {
        const uint32_t b = words[fg_word * 32];
        if (b) {
          next_fg = 32 * fg_word + __ffs(b) - 1;
          break;
        }
      }
    }
    if (bg_word <= k) {
      next_bg = INF;
      for (bg_word = k + 1; bg_word < nwords; ++bg_word) {
        const int m = min(32, rh - 32 * bg_word);
        const uint32_t b =
            ~words[bg_word * 32] & (m == 32 ? FULL : (1u << m) - 1u);
        if (b) {
          next_bg = 32 * bg_word + __ffs(b) - 1;
          break;
        }
      }
    }
    int16_t* q = dst + (size_t)base * rw;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i < n) {
        const bool is_fg = (fgb >> i) & 1u;
        const uint32_t other = is_fg ? bgb : fgb;
        const uint32_t below = other & ((1u << i) - 1u);   // rows above i
        const uint32_t above = other & ~((2u << i) - 1u);  // rows below i
        const int y = base + i;
        const int up = below ? i - (31 - __clz(below))
                             : y - (is_fg ? last_bg : last_fg);
        const int dn = above ? __ffs(above) - 1 - i
                             : (is_fg ? next_bg : next_fg) - y;
        const int c = min(min(up, dn), SENT);
        q[i * rw] = (int16_t)(is_fg ? -c : c);
      }
    }
    if (fgb) last_fg = base + 31 - __clz(fgb);
    if (bgb) last_bg = base + 31 - __clz(bgb);
  }
}

// The exclusive prefix minima of pa and pb and the exclusive suffix minima of
// sa and sb over the CTA's threads, in thread order; INF for the first (last)
// thread. blockDim.x is a multiple of 32, every thread calls it.
__device__ __forceinline__ void cta_excl_min(int& pa, int& pb, int& sa,
                                             int& sb, int4* wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int ia = pa, ib = pb, ja = sa, jb = sb;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int oa = __shfl_up_sync(FULL, ia, d);
    const int ob = __shfl_up_sync(FULL, ib, d);
    const int qa = __shfl_down_sync(FULL, ja, d);
    const int qb = __shfl_down_sync(FULL, jb, d);
    if (lane >= d) {
      ia = min(ia, oa);
      ib = min(ib, ob);
    }
    if (lane + d < 32) {
      ja = min(ja, qa);
      jb = min(jb, qb);
    }
  }
  pa = __shfl_up_sync(FULL, ia, 1);
  pb = __shfl_up_sync(FULL, ib, 1);
  sa = __shfl_down_sync(FULL, ja, 1);
  sb = __shfl_down_sync(FULL, jb, 1);
  if (lane == 0) pa = pb = INF;
  if (lane == 31) sa = sb = INF;
  if (lane == 31) wtot[warp].x = ia, wtot[warp].y = ib;
  if (lane == 0) wtot[warp].z = ja, wtot[warp].w = jb;
  __syncthreads();
  for (int i = 0; i < nw; ++i) {
    const int4 o = wtot[i];
    if (i < warp) {
      pa = min(pa, o.x);
      pb = min(pb, o.y);
    }
    if (i > warp) {
      sa = min(sa, o.z);
      sb = min(sb, o.w);
    }
  }
}

// Pass 2. Grid: one CTA per (image, ROI row), image-major; blockDim.x threads
// (a multiple of 32), thread t owning the chunk [t * chunk, (t + 1) * chunk)
// of the row. Dynamic shared memory: the row and its forward chain, 2 * rw
// int16.
//
// D(x) = min(F(x), B(x)), the forward and the backward chain of the pixel's
// class, each over C alone. A thread runs both over its chunk from no carry;
// the carries are closed forms of the chunks' ends (starts): with P the
// exclusive prefix minimum of F_end(i) - chunk * i, F(x) = min(F_local(x),
// P + x + 1 - chunk); with S the exclusive suffix minimum of B_start(i) +
// chunk * i, B(x) = min(B_local(x), S - x).
__global__ void __launch_bounds__(ROW_THREADS)
sdf2d_rows_kernel(int16_t* __restrict__ dist, int* __restrict__ abs_max,
                  int rh, int rw, int chunk) {
  extern __shared__ __align__(16) int16_t row[];
  __shared__ int4 wtot[ROW_THREADS / 32];
  __shared__ int wmax[ROW_THREADS / 32];
  int16_t* fwd = row + ((rw + 7) & ~7);
  const int t = threadIdx.x, nt = blockDim.x;
  int16_t* g = dist + (size_t)blockIdx.x * rw;
  // the row's start is 16-byte aligned where rw % 8 == 0
  const bool wide = (rw & 7) == 0;
  if (wide) {
    for (int i = t; i < rw / 8; i += nt)
      reinterpret_cast<int4*>(row)[i] = reinterpret_cast<const int4*>(g)[i];
  } else {
    for (int x = t; x < rw; x += nt) row[x] = g[x];
  }
  __syncthreads();
  const int lo = min(t * chunk, rw), hi = min(lo + chunk, rw);

  // Chain a seeks the background (0 on it, c on the foreground), chain b
  // the foreground. A pixel keeps its own chain's value (>= 1); the other
  // chain's is 0 there.
  int fa = INF, fb = INF;
  for (int x = lo; x < hi; ++x) {
    const int s = row[x];
    const bool fgp = s < 0;
    const int m = abs(s);
    fa = fgp ? min(m, fa + 1) : 0;
    fb = fgp ? 0 : min(m, fb + 1);
    fwd[x] = (int16_t)min(fgp ? fa : fb, SENT);
  }
  int ba = INF, bb = INF;
  for (int x = hi - 1; x >= lo; --x) {
    const int s = row[x];
    const bool fgp = s < 0;
    const int m = abs(s);
    ba = fgp ? min(m, ba + 1) : 0;
    bb = fgp ? 0 : min(m, bb + 1);
    const int own = min(fgp ? ba : bb, SENT);
    row[x] = (int16_t)(fgp ? -own : own);
  }
  fa -= chunk * t;
  fb -= chunk * t;
  ba += chunk * t;
  bb += chunk * t;
  cta_excl_min(fa, fb, ba, bb, wtot);
  fa += 1 - chunk;
  fb += 1 - chunk;
  int most = 0;
  for (int x = lo; x < hi; ++x) {
    const int s = row[x];
    const bool fgp = s < 0;
    const int d = min(min(min(abs(s), (int)fwd[x]),
                          min((fgp ? fa : fb) + x, (fgp ? ba : bb) - x)),
                      SENT);
    most = max(most, d);
    row[x] = (int16_t)(fgp ? -d : d);
  }
  most = __reduce_max_sync(FULL, most);
  if ((t & 31) == 0) wmax[t >> 5] = most;
  __syncthreads();
  if (wide) {
    for (int i = t; i < rw / 8; i += nt)
      reinterpret_cast<int4*>(g)[i] = reinterpret_cast<const int4*>(row)[i];
  } else {
    for (int x = t; x < rw; x += nt) g[x] = row[x];
  }
  if (t == 0) {
    for (int i = 1; i < nt / 32; ++i) most = max(most, wmax[i]);
    atomicMax(abs_max + blockIdx.x / rh, most);
  }
}

// torch.minimum's float: a NaN of either operand propagates
__device__ __forceinline__ float torch_min(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}

// One pixel of pass 3: the signed distance s as f32, then the mode's scale and
// the truncation, in the plain version's order.
__device__ __forceinline__ float finish(int s, int mode, int use_trunc,
                                       float scale, float norm, float band,
                                       float invalid) {
  const int m = abs(s);
  const float mag = m >= SENT ? FLT_MAX : (float)m;
  float r = s < 0 ? -mag : mag;
  if (mode == SCALE) r = r * scale;
  else if (mode == MINMAX) r = r * norm;
  if (use_trunc)
    r = -band >= r ? invalid
        : mode == SCALE ? torch_min(band, r)
                        : torch_min(1.0f, r / band);
  return r;
}

// Pass 3. Grid: one CTA per image row (image-major), FIN_THREADS threads.
// quad: w, x0 and rw are multiples of 4, so four pixels move as one float4
// and one 8-byte load.
__global__ void __launch_bounds__(FIN_THREADS)
sdf2d_finish_kernel(const int16_t* __restrict__ dist,
                    const int* __restrict__ abs_max, float* __restrict__ out,
                    int h, int w, int x0, int y0, int rh, int rw, int mode,
                    int use_trunc, float scale, float band, float invalid,
                    int quad) {
  const int v = blockIdx.x / h, yr = blockIdx.x % h - y0;
  float* o = out + (size_t)blockIdx.x * w;
  if (yr < 0 || yr >= rh) {
    for (int x = threadIdx.x; x < w; x += blockDim.x) o[x] = 0.0f;
    return;
  }
  float norm = 1.0f;
  if (mode == MINMAX) {  // 1/abs_max rounds once, then multiplies
    const int a = abs_max[v];
    const float af = a >= SENT ? FLT_MAX : (float)a;
    norm = af > FLT_MIN ? 1.0f / af : 1.0f;
  }
  const int16_t* d = dist + ((size_t)v * rh + yr) * rw;
  if (quad) {
    for (int x = 4 * threadIdx.x; x < w; x += 4 * blockDim.x) {
      const int xr = x - x0;
      float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (xr >= 0 && xr < rw) {
        const short4 s = *reinterpret_cast<const short4*>(d + xr);
        r.x = finish(s.x, mode, use_trunc, scale, norm, band, invalid);
        r.y = finish(s.y, mode, use_trunc, scale, norm, band, invalid);
        r.z = finish(s.z, mode, use_trunc, scale, norm, band, invalid);
        r.w = finish(s.w, mode, use_trunc, scale, norm, band, invalid);
      }
      *reinterpret_cast<float4*>(o + x) = r;
    }
    return;
  }
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    const int xr = x - x0;
    o[x] = xr >= 0 && xr < rw
               ? finish(d[xr], mode, use_trunc, scale, norm, band, invalid)
               : 0.0f;
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= (size_t)SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// The signed distance fields of n_views masks [n_views, h, w] (bytes; fg is
// the foreground's byte: 255 for uint8, 1 for bool) into out f32[n_views, h,
// w]. dist is int16 scratch of [n_views, y1 - y0 + 1, x1 - x0 + 1], abs_max
// int32 scratch of [n_views]; neither needs zeroing. mode: 0 raw, 1 times
// scale, 2 min-max; use_trunc applies the truncation band. Three launches on
// stream, each checked.
extern "C" int vt_sdf2d(const uint8_t* mask, int16_t* dist, int* abs_max,
                        float* out, int n_views, int h, int w, int x0, int y0,
                        int x1, int y1, int fg, int mode, int use_trunc,
                        float scale, float band, float invalid, void* stream) {
  if (n_views <= 0 || h <= 0 || w <= 0 || h + w > MAX_SIDES)
    return (int)cudaErrorInvalidValue;
  if (x0 < 0 || x0 > x1 || x1 >= w || y0 < 0 || y0 > y1 || y1 >= h)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)n_views * h > INT32_MAX || fg < 1 || fg > 255 || mode < RAW ||
      mode > MINMAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rh = y1 - y0 + 1, rw = x1 - x0 + 1;

  const int nwords = (rh + 31) / 32;
  const int segs = min(COL_SEGS, nwords);
  const int per = (nwords + segs - 1) / segs;
  const int strips = (rw + 31) / 32;
  if ((int64_t)strips * n_views > INT32_MAX) return (int)cudaErrorInvalidValue;
  const size_t col_bytes = (size_t)nwords * 32 * sizeof(uint32_t);
  cudaError_t err = allow_smem((const void*)sdf2d_columns_kernel, col_bytes);
  if (err != cudaSuccess) return (int)err;
  sdf2d_columns_kernel<<<strips * n_views, dim3(32, segs), col_bytes, s>>>(
      mask, dist, abs_max, strips, h, w, x0, y0, rh, rw, nwords, per, fg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  int nt = ((rw + ROW_PIXELS - 1) / ROW_PIXELS + 31) / 32 * 32;
  nt = min(nt, ROW_THREADS);
  const int chunk = (rw + nt - 1) / nt;
  const size_t row_bytes = (size_t)((rw + 7) & ~7) * 2 * sizeof(int16_t);
  if ((err = allow_smem((const void*)sdf2d_rows_kernel, row_bytes)) !=
      cudaSuccess)
    return (int)err;
  sdf2d_rows_kernel<<<n_views * rh, nt, row_bytes, s>>>(dist, abs_max, rh, rw,
                                                        chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int quad = w % 4 == 0 && x0 % 4 == 0 && rw % 4 == 0;
  sdf2d_finish_kernel<<<n_views * h, FIN_THREADS, 0, s>>>(
      dist, abs_max, out, h, w, x0, y0, rh, rw, mode, use_trunc, scale, band,
      invalid, quad);
  return (int)cudaGetLastError();
}
