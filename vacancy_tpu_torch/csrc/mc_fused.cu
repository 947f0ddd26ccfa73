// Fused marching cubes for Hopper (sm_90a): geometry + stream compaction.
//
// Replaces the TPU kernel vacancy_tpu/ops/mc_fused.py::_mc_fused_kernel
// (launched by mc_fused_call). For every voxel (k, j, i) -- flat id
// lin = (k*ny + j)*nx + i -- it decides four flags and their payloads:
//   x/y/z edge: the canonical edge from the voxel to its +axis neighbour
//     straddles the iso level and one of the 4 cubes sharing it is valid;
//     payload (position along the axis, lin), linear or no-interp rule;
//   active cube: the cube based at the voxel is valid and its case is not
//     0 or 255; payload (lin, case).
// A cube is valid when its 8 corners are not InvalidSdf and its corner 6,
// (k+1, j+1, i+1), has update_num >= 1 (marching_cubes.cc:88-112).
// Each stream is compacted in flat (z, y, x) order -- the order the host
// assembly (ops/mc_fused.assemble_fused_streams) needs for an identical
// mesh -- by three passes in place of the TPU kernel's shift ladder and
// capacity retry:
//   1. count: one CTA per tile of TILE consecutive voxels of one plane
//      counts each stream's flags;
//   2. scan: one CTA turns the tile counts into exclusive offsets, the
//      four totals and per-plane counts;
//   3. emit: the count pass's flags again, ranked in the tile with warp
//      ballots and popc, written to buffers sized exactly to the totals.
// Each pass has a C entry point of its own (vt_mc_count, vt_mc_scan,
// vt_mc_emit), so the scan and the compaction can be held against
// torch.cumsum and boolean-mask compaction by themselves -- what the TPU
// package's cumsum_kernel and compact_kernel harnesses
// (tests/test_mc_fused.py) do for its in-kernel primitives.
//
// What bounds it on the card: reading the state (8 bytes per voxel, 134 MB
// at 256^3) twice, plus the validity of up to 7 neighbouring cubes for
// voxels that straddle the surface. Cube validity of plane k-1 is
// recomputed from planes k-1 and k (blocks run in no order; nothing is
// carried between them), but only for voxels with a straddling edge, which
// are a thin shell, so the cost tracks surface occupancy.
//
// A sharded caller (parallel/sharded.py) passes a halo-extended LOCAL block:
// every mask (lattice, cube validity, adjacency) stays array-local -- the
// halos of an out-of-grid side carry InvalidSdf, so dense semantics hold --
// while only voxels inside the emission window own_lo <= (k, j, i) < own_hi
// emit (the TPU kernel's own_k / own_j / own_i), and linear ids are GLOBAL:
// lin = (k + zb)*gny*gnx + (j + yb)*gnx + (i + xb) (its zb, yx_base, gdims).
// A voxel outside the window returns before any load. The defaults (the
// whole array, bases 0, gny = ny, gnx = nx) give the unsharded ids; a
// window that is the whole array takes kernels compiled without the test
// (template parameter WIN): with it the count pass needs 60 registers
// where it had 47, one block per SM fewer, and the unsharded path would pay
// for a test that is always true.
//
// Numerics: built with -fmad=false and IEEE division; the vertex
// interpolation keeps ops/mc_fused._edge_vertex_interp's order.
// Linear ids are int32 (fine up to a GLOBAL grid of 1024^3; the wrapper
// refuses more). The kernels allocate nothing
// and run on the caller's stream; each C entry point returns cudaError_t.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;  // voxels per tile (one plane's flat range)
constexpr int NT = 256;     // threads per count/emit CTA
constexpr int PER = TILE / NT;
constexpr int NWARPS = NT / 32;
constexpr int SCAN_NT = 1024;
constexpr float INVALID = -FLT_MAX;

struct McArgs {
  const float* sdf;  // [nz, ny, nx]
  const int* un;     // [nz, ny, nx] update_num
  const float* cx;
  const float* cy;
  const float* cz;
  int nz, ny, nx;
  float iso;
  int linear;
  int tiles_per_plane;
  int own_lo[3], own_hi[3];  // emission window, local (k, j, i)
  int zb, yb, xb;            // global coordinate of local (0, 0, 0)
  int gny, gnx;              // global plane dims, for linear ids only
};

struct McOut {
  float* vx_pos;
  int* vx_lin;
  float* vy_pos;
  int* vy_lin;
  float* vz_pos;
  int* vz_lin;
  int* c_lin;
  int* c_case;
};

__device__ __forceinline__ float load_sdf(const McArgs& a, int k, int j,
                                          int i) {
  if (k >= a.nz || j >= a.ny || i >= a.nx) return INVALID;
  return a.sdf[((int64_t)k * a.ny + j) * a.nx + i];
}

// validity of the cube based at (k, j, i); out-of-lattice cubes are invalid
__device__ bool cube_valid(const McArgs& a, int k, int j, int i) {
  if (k < 0 || j < 0 || i < 0 || k >= a.nz - 1 || j >= a.ny - 1 ||
      i >= a.nx - 1)
    return false;
  const int64_t sy = a.nx, sz = (int64_t)a.ny * a.nx;
  const float* p = a.sdf + k * sz + j * sy + i;
  if (p[0] == INVALID || p[1] == INVALID || p[sy] == INVALID ||
      p[sy + 1] == INVALID || p[sz] == INVALID || p[sz + 1] == INVALID ||
      p[sz + sy] == INVALID || p[sz + sy + 1] == INVALID)
    return false;
  return a.un[k * sz + j * sy + i + sz + sy + 1] >= 1;
}

__device__ __forceinline__ float edge_interp(float s0, float s1, float p0,
                                             float p1, float iso) {
  const float denom = s1 - s0;
  const float mu = fabsf(denom) < 1e-5f ? 0.0f : (iso - s0) / denom;
  float t = fabsf(iso - s0) < 1e-5f ? 0.0f : mu;
  t = fabsf(iso - s1) < 1e-5f ? 1.0f : t;
  const float d = p1 - p0;
  const float td = t * d;
  return p0 + td;
}

struct VoxelFlags {
  unsigned bits;  // 1 x-edge, 2 y-edge, 4 z-edge, 8 active cube
  float px, py, pz;
  int cse;
};

// flags (and, with want_pos, payloads) of plane-local voxel `e` of plane k;
// WIN: the emission window is smaller than the array
template <bool WIN>
__device__ VoxelFlags voxel_flags(const McArgs& a, int k, int e,
                                  bool want_pos) {
  VoxelFlags f{0u, 0.0f, 0.0f, 0.0f, 0};
  const int j = e / a.nx;
  const int i = e - j * a.nx;
  // halo planes, rows and lanes of a sharded block emit nothing
  if (WIN && (k < a.own_lo[0] || k >= a.own_hi[0] || j < a.own_lo[1] ||
              j >= a.own_hi[1] || i < a.own_lo[2] || i >= a.own_hi[2]))
    return f;
  // corners in CORNER_OFFSETS order: 0 (0,0,0) 1 (1,0,0) 2 (1,1,0)
  // 3 (0,1,0), 4..7 the same at z+1; out-of-grid corners are invalid
  float c[8];
  c[0] = load_sdf(a, k, j, i);
  c[1] = load_sdf(a, k, j, i + 1);
  c[2] = load_sdf(a, k, j + 1, i + 1);
  c[3] = load_sdf(a, k, j + 1, i);
  c[4] = load_sdf(a, k + 1, j, i);
  c[5] = load_sdf(a, k + 1, j, i + 1);
  c[6] = load_sdf(a, k + 1, j + 1, i + 1);
  c[7] = load_sdf(a, k + 1, j + 1, i);
  int cse = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) cse |= (c[q] < a.iso ? 1 : 0) << q;
  const bool in0 = c[0] < a.iso;
  const bool sx = (in0 != (c[1] < a.iso)) && i < a.nx - 1;
  const bool sy = (in0 != (c[3] < a.iso)) && j < a.ny - 1;
  const bool sz = in0 != (c[4] < a.iso);
  const bool cv = cube_valid(a, k, j, i);
  if (cv && cse != 0 && cse != 255) f.bits |= 8u;
  f.cse = cse;
  if (!(sx || sy || sz)) return f;

  // the cubes adjacent to this voxel's three edges
  const bool v_jm = cube_valid(a, k, j - 1, i);
  const bool v_im = cube_valid(a, k, j, i - 1);
  const bool v_jmim = cube_valid(a, k, j - 1, i - 1);
  const bool p_0 = cube_valid(a, k - 1, j, i);
  const bool p_jm = cube_valid(a, k - 1, j - 1, i);
  const bool p_im = cube_valid(a, k - 1, j, i - 1);

  // x-edge: adjacent cubes in (z, y) scan order (k-1,j-1) (k-1,j)
  // (k,j-1) (k,j); no-interp roles U,L,U,L
  if (sx && (p_jm || p_0 || v_jm || cv)) {
    f.bits |= 1u;
    if (want_pos) {
      if (a.linear) {
        f.px = edge_interp(c[0], c[1], a.cx[i], a.cx[i + 1], a.iso);
      } else {
        const bool up = p_jm || (!p_jm && !p_0 && v_jm);
        f.px = up ? a.cx[i + 1] : a.cx[i];
      }
    }
  }
  // y-edge: (z, x) scan order (k-1,i-1) (k-1,i) (k,i-1) (k,i);
  // roles L,U,L,U
  if (sy && (p_im || p_0 || v_im || cv)) {
    f.bits |= 2u;
    if (want_pos) {
      if (a.linear) {
        f.py = edge_interp(c[0], c[3], a.cy[j], a.cy[j + 1], a.iso);
      } else {
        const bool up = (!p_im && p_0) || (!p_im && !p_0 && !v_im && cv);
        f.py = up ? a.cy[j + 1] : a.cy[j];
      }
    }
  }
  // z-edge: (y, x) scan order (j-1,i-1) (j-1,i) (j,i-1) (j,i), all at
  // plane k; no-interp takes the lower end
  if (sz && (v_jmim || v_jm || v_im || cv)) {
    f.bits |= 4u;
    if (want_pos) {
      if (a.linear) {
        const float z1 = a.cz[min(k + 1, a.nz - 1)];
        f.pz = edge_interp(c[0], c[4], a.cz[k], z1, a.iso);
      } else {
        f.pz = a.cz[k];
      }
    }
  }
  return f;
}

__device__ __forceinline__ void tile_coords(const McArgs& a, int* k,
                                            int* base, int* end) {
  const int b = (int)blockIdx.x;
  const int t = b % a.tiles_per_plane;
  *k = b / a.tiles_per_plane;
  *base = t * TILE;
  *end = min(*base + TILE, a.ny * a.nx);
}

template <bool WIN>
__global__ void __launch_bounds__(NT)
mc_count_kernel(McArgs a, int* tile_counts) {
  __shared__ int part[NWARPS][4];
  int k, base, end;
  tile_coords(a, &k, &base, &end);
  int cnt[4] = {0, 0, 0, 0};
  const int tid = (int)threadIdx.x;
  for (int it = 0; it < PER; ++it) {
    const int e = base + it * NT + tid;
    if (e < end) {
      const unsigned b = voxel_flags<WIN>(a, k, e, false).bits;
#pragma unroll
      for (int s = 0; s < 4; ++s) cnt[s] += (b >> s) & 1u;
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int w = __reduce_add_sync(0xffffffffu, cnt[s]);
    if (lane == 0) part[warp][s] = w;
  }
  __syncthreads();
  if (tid < 4) {
    int sum = 0;
    for (int w = 0; w < NWARPS; ++w) sum += part[w][tid];
    tile_counts[(int64_t)blockIdx.x * 4 + tid] = sum;
  }
}

// One CTA: exclusive offsets of every tile's counts per stream, the four
// totals, and per-plane counts (each plane is tiles_per_plane tiles).
__global__ void __launch_bounds__(SCAN_NT)
mc_scan_kernel(const int* tile_counts, int* tile_offsets, int* totals,
               int* plane_counts, int n_tiles, int tiles_per_plane, int nz) {
  __shared__ int sums[SCAN_NT][4];
  const int tid = (int)threadIdx.x;
  const int chunk = (n_tiles + SCAN_NT - 1) / SCAN_NT;
  const int lo = min(tid * chunk, n_tiles);
  const int hi = min(lo + chunk, n_tiles);
  int acc[4] = {0, 0, 0, 0};
  for (int t = lo; t < hi; ++t)
    for (int s = 0; s < 4; ++s) acc[s] += tile_counts[(int64_t)t * 4 + s];
  for (int s = 0; s < 4; ++s) sums[tid][s] = acc[s];
  __syncthreads();
  // Hillis-Steele inclusive scan over the per-thread sums
  for (int d = 1; d < SCAN_NT; d <<= 1) {
    int v[4];
    for (int s = 0; s < 4; ++s) v[s] = tid >= d ? sums[tid - d][s] : 0;
    __syncthreads();
    for (int s = 0; s < 4; ++s) sums[tid][s] += v[s];
    __syncthreads();
  }
  for (int s = 0; s < 4; ++s) {
    int run = sums[tid][s] - acc[s];  // exclusive
    for (int t = lo; t < hi; ++t) {
      tile_offsets[(int64_t)t * 4 + s] = run;
      run += tile_counts[(int64_t)t * 4 + s];
    }
  }
  if (tid < 4) totals[tid] = sums[SCAN_NT - 1][tid];
  __syncthreads();
  for (int kk = tid; kk < nz; kk += SCAN_NT) {
    const int64_t t0 = (int64_t)kk * tiles_per_plane;
    const int64_t t1 = t0 + tiles_per_plane;
    for (int s = 0; s < 4; ++s) {
      const int end = t1 < n_tiles ? tile_offsets[t1 * 4 + s]
                                   : sums[SCAN_NT - 1][s];
      plane_counts[(int64_t)kk * 4 + s] = end - tile_offsets[t0 * 4 + s];
    }
  }
}

template <bool WIN>
__global__ void __launch_bounds__(NT)
mc_emit_kernel(McArgs a, const int* tile_offsets, McOut o) {
  __shared__ int wtot[PER][NWARPS][4];
  int k, base, end;
  tile_coords(a, &k, &base, &end);
  const int tid = (int)threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;

  VoxelFlags f[PER];
  unsigned rank_in_warp[PER][4];
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int e = base + it * NT + tid;
    f[it] = e < end ? voxel_flags<WIN>(a, k, e, true)
                    : VoxelFlags{0u, 0.0f, 0.0f, 0.0f, 0};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const unsigned ball = __ballot_sync(0xffffffffu, (f[it].bits >> s) & 1u);
      rank_in_warp[it][s] = __popc(ball & lt_mask);
      if (lane == 0) wtot[it][warp][s] = __popc(ball);
    }
  }
  __syncthreads();

  const int64_t tb = (int64_t)blockIdx.x * 4;
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    if (!f[it].bits) continue;
    // only owned voxels reach here: their global ids are in range even
    // where plane, row or lane 0 is a halo and the base is -1
    const int e = base + it * NT + tid;
    const int j = e / a.nx;
    const int lin = (k + a.zb) * a.gny * a.gnx + (j + a.yb) * a.gnx +
                    (e - j * a.nx + a.xb);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!((f[it].bits >> s) & 1u)) continue;
      // elements before this one in the tile: earlier (iteration, warp)
      // groups, then earlier lanes of this warp
      int pos = tile_offsets[tb + s] + (int)rank_in_warp[it][s];
      for (int q = 0; q < it * NWARPS + warp; ++q)
        pos += wtot[q / NWARPS][q % NWARPS][s];
      switch (s) {
        case 0: o.vx_pos[pos] = f[it].px; o.vx_lin[pos] = lin; break;
        case 1: o.vy_pos[pos] = f[it].py; o.vy_lin[pos] = lin; break;
        case 2: o.vz_pos[pos] = f[it].pz; o.vz_lin[pos] = lin; break;
        default: o.c_lin[pos] = lin; o.c_case[pos] = f[it].cse; break;
      }
    }
  }
}

// win = {own_k lo, hi, own_j lo, hi, own_i lo, hi, zb, yb, xb, gny, gnx}

bool make_args(const float* sdf, const int* un, const float* cx,
               const float* cy, const float* cz, int nz, int ny, int nx,
               float iso, int linear, const int* win, McArgs* a) {
  if (nz < 1 || ny < 1 || nx < 1 || win == nullptr) return false;
  const int dims[3] = {nz, ny, nx};
  for (int d = 0; d < 3; ++d)
    if (win[2 * d] < 0 || win[2 * d + 1] > dims[d] ||
        win[2 * d] > win[2 * d + 1])
      return false;
  if (win[9] < 1 || win[10] < 1) return false;
  const int tpp = (ny * nx + TILE - 1) / TILE;
  *a = McArgs{sdf, un, cx, cy, cz, nz, ny, nx, iso, linear, tpp,
              {win[0], win[2], win[4]}, {win[1], win[3], win[5]},
              win[6], win[7], win[8], win[9], win[10]};
  return true;
}

bool windowed(const McArgs& a) {
  return a.own_lo[0] > 0 || a.own_lo[1] > 0 || a.own_lo[2] > 0 ||
         a.own_hi[0] < a.nz || a.own_hi[1] < a.ny || a.own_hi[2] < a.nx;
}

}  // namespace

extern "C" int vt_mc_tiles(int ny, int nx) {
  return (ny * nx + TILE - 1) / TILE;
}

// Pass 1: tile_counts is [n_tiles, 4], n_tiles = nz * vt_mc_tiles(ny, nx).
// win is a HOST array of 11 ints (see make_args): the emission window,
// the global bases and the global plane dims.
extern "C" int vt_mc_count(const float* sdf, const int* un, const float* cx,
                           const float* cy, const float* cz, int nz, int ny,
                           int nx, float iso, int linear, const int* win,
                           int* tile_counts, void* stream) {
  McArgs a;
  if (!make_args(sdf, un, cx, cy, cz, nz, ny, nx, iso, linear, win, &a))
    return (int)cudaErrorInvalidValue;
  const int grid = nz * a.tiles_per_plane;
  if (windowed(a))
    mc_count_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
        a, tile_counts);
  else
    mc_count_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(
        a, tile_counts);
  return (int)cudaGetLastError();
}

// Pass 2 on its own: tile_counts [n_tiles, 4] -> exclusive tile_offsets
// [n_tiles, 4], totals [4] and plane_counts [nz, 4], where
// n_tiles = nz * tiles_per_plane. One CTA walks every tile.
extern "C" int vt_mc_scan(const int* tile_counts, int* tile_offsets,
                          int* totals, int* plane_counts, int n_tiles,
                          int tiles_per_plane, int nz, void* stream) {
  if (nz < 1 || tiles_per_plane < 1 || n_tiles != nz * tiles_per_plane)
    return (int)cudaErrorInvalidValue;
  mc_scan_kernel<<<1, SCAN_NT, 0, (cudaStream_t)stream>>>(
      tile_counts, tile_offsets, totals, plane_counts, n_tiles,
      tiles_per_plane, nz);
  return (int)cudaGetLastError();
}

// Pass 3: writes each stream to buffers of exactly totals[s] elements; win
// as in vt_mc_count (the two passes must be given the same window).
extern "C" int vt_mc_emit(const float* sdf, const int* un, const float* cx,
                          const float* cy, const float* cz, int nz, int ny,
                          int nx, float iso, int linear, const int* win,
                          const int* tile_offsets, float* vx_pos,
                          int* vx_lin, float* vy_pos, int* vy_lin,
                          float* vz_pos, int* vz_lin, int* c_lin,
                          int* c_case, void* stream) {
  McArgs a;
  if (!make_args(sdf, un, cx, cy, cz, nz, ny, nx, iso, linear, win, &a))
    return (int)cudaErrorInvalidValue;
  const McOut o{vx_pos, vx_lin, vy_pos, vy_lin, vz_pos, vz_lin, c_lin,
                c_case};
  const int grid = nz * a.tiles_per_plane;
  if (windowed(a))
    mc_emit_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
        a, tile_offsets, o);
  else
    mc_emit_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(
        a, tile_offsets, o);
  return (int)cudaGetLastError();
}
