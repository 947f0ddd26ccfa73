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
//   2. scan: the tile counts become exclusive offsets, the four totals and
//      per-plane counts. Every block of SCAN_BLOCK tiles sums its counts;
//      one CTA scans the block sums; every block scans its own tiles from
//      its block's prefix; a last launch takes the per-plane differences.
//      The sums are int32, so the result does not depend on any order;
//   3. emit: a tile whose four counts are 0 (four of five at 1024^3: a
//      tile is a run of one row, non-empty where the row meets the surface)
//      returns after two 16-byte loads; the others compute the count
//      pass's flags again, rank them in the tile with warp ballots and one
//      scan of the (iteration, warp) group totals, and write them to
//      buffers sized exactly to the totals.
// Each pass has a C entry point of its own (vt_mc_count, vt_mc_scan,
// vt_mc_emit), so the scan and the compaction can be held against
// torch.cumsum and boolean-mask compaction by themselves -- what the TPU
// package's cumsum_kernel and compact_kernel harnesses
// (tests/test_mc_fused.py) do for its in-kernel primitives.
//
// What bounds it on the card: by the count of bytes, reading the state (8
// bytes per voxel) in the count pass and again for the non-empty tiles of
// the emit pass; in fact the count pass is bound by its compares, selects
// and bit operations, which run at half the rate of float adds.
// What the design does about it: a thread loads only its own column of
// the cube based at its voxel -- sdf at (k, j, i), (k, j+1, i), (k+1, j, i),
// (k+1, j+1, i) and update_num at (k+1, j+1, i): five loads, all coalesced
// along x, those of a thread's four voxels all in flight together -- and
// keeps six bits of it (four "below iso", "all valid", "updated"). It takes
// the bits of column i + 1 from the next lane by a warp shuffle, a warp's
// last lane from the next warp's first through shared memory, and only the
// tile's last voxel loads that column itself. A voxel whose eight corner
// bits agree (most) leaves at once. The validity of the six neighbouring
// cubes, nine loads each that do not wait for one another, is looked up
// only for voxels with a straddling edge, and an edge's two ends are read
// again only where a vertex is emitted: those are a thin shell, so that
// cost tracks surface occupancy. A tile is a flat range of one plane, so
// (j, i) advance without a division per voxel, and every index is 32 bits.
//
// A sharded caller (parallel/sharded.py) passes a halo-extended LOCAL block:
// every mask (lattice, cube validity, adjacency) stays array-local -- the
// halos of an out-of-grid side carry InvalidSdf, so dense semantics hold --
// while only voxels inside the emission window own_lo <= (k, j, i) < own_hi
// emit (the TPU kernel's own_k / own_j / own_i), and linear ids are GLOBAL:
// lin = (k + zb)*gny*gnx + (j + yb)*gnx + (i + xb) (its zb, yx_base, gdims).
// A plane outside the window is left by the whole CTA, a row or lane
// outside it loads nothing (but the one lane past the window, whose column
// its neighbour needs). The defaults (the whole array, bases 0, gny = ny,
// gnx = nx) give the unsharded ids; a window that is the whole array takes
// kernels compiled without the test (template parameter WIN), so the
// unsharded path does not pay, in registers, for a test that is always
// true.
//
// Numerics: built with -fmad=false and IEEE division; the vertex
// interpolation keeps ops/mc_fused._edge_vertex_interp's order.
// Linear ids are int32 (fine up to a GLOBAL grid of 1024^3; the wrapper
// refuses more). The kernels allocate nothing (the scan's block sums live
// in a scratch array of the wrapper's) and run on the caller's stream;
// each C entry point returns cudaError_t.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;  // voxels per tile (one plane's flat range)
constexpr int NT = 256;     // threads per count/emit CTA
constexpr int PER = TILE / NT;
constexpr int NWARPS = NT / 32;
constexpr int NGROUPS = PER * NWARPS;  // (iteration, warp) groups of a tile
static_assert(NGROUPS == 32, "the emit pass scans the groups in one warp");
constexpr int SCAN_NT = 256;   // threads of a scan CTA
constexpr int SCAN_PER = 4;    // tiles per thread
constexpr int SCAN_BLOCK = SCAN_NT * SCAN_PER;  // tiles per scan block
constexpr int SCAN_TOP_NT = 1024;  // the one CTA over the block sums
constexpr float INVALID = -FLT_MAX;
constexpr unsigned FULL = 0xffffffffu;

struct McArgs {
  const float* sdf;  // [nz, ny, nx]
  const int* un;     // [nz, ny, nx] update_num
  const float* cx;
  const float* cy;
  const float* cz;
  int nz, ny, nx;
  int plane;  // ny * nx; the array holds fewer than 2^31 voxels
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

// validity of the cube based at (k, j, i); out-of-lattice cubes are invalid.
// The nine loads do not wait for one another.
__device__ __forceinline__ bool cube_valid(const McArgs& a, int k, int j,
                                           int i) {
  if (k < 0 || j < 0 || i < 0 || k >= a.nz - 1 || j >= a.ny - 1 ||
      i >= a.nx - 1)
    return false;
  const int sy = a.nx, sz = a.plane;
  const int o = k * sz + j * sy + i;
  const float* p = a.sdf + o;
  const float c0 = p[0], c1 = p[1], c2 = p[sy], c3 = p[sy + 1];
  const float c4 = p[sz], c5 = p[sz + 1], c6 = p[sz + sy];
  const float c7 = p[sz + sy + 1];
  const int u = a.un[o + sz + sy + 1];
  return (c0 != INVALID) & (c1 != INVALID) & (c2 != INVALID) &
         (c3 != INVALID) & (c4 != INVALID) & (c5 != INVALID) &
         (c6 != INVALID) & (c7 != INVALID) & (u >= 1);
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

// The column of a cube at one x: sdf at (k, j), (k, j+1), (k+1, j),
// (k+1, j+1) and update_num at (k+1, j+1). Rows and planes past the grid
// are invalid voxels, as every out-of-grid corner is.
struct Column {
  float s00, s01, s10, s11;
  int u11;
};

__device__ __forceinline__ Column invalid_column() {
  return Column{INVALID, INVALID, INVALID, INVALID, 0};
}

// The column at flat index `idx` of a voxel inside the grid; jn, kn: its
// row j + 1 and its plane k + 1 are inside the grid too.
__device__ __forceinline__ Column load_column(const McArgs& a, int idx,
                                              bool jn, bool kn) {
  Column c = invalid_column();
  c.s00 = a.sdf[idx];
  if (jn) c.s01 = a.sdf[idx + a.nx];
  if (kn) c.s10 = a.sdf[idx + a.plane];
  if (jn && kn) {
    c.s11 = a.sdf[idx + a.plane + a.nx];
    c.u11 = a.un[idx + a.plane + a.nx];
  }
  return c;
}

// bits 0..3: s00, s01, s10, s11 below the iso level; 4: all four valid;
// 5: update_num at (k+1, j+1) >= 1
__device__ __forceinline__ unsigned column_bits(const McArgs& a,
                                                const Column& c) {
  unsigned b = (c.s00 < a.iso ? 1u : 0u) | (c.s01 < a.iso ? 2u : 0u) |
               (c.s10 < a.iso ? 4u : 0u) | (c.s11 < a.iso ? 8u : 0u);
  if (c.s00 != INVALID && c.s01 != INVALID && c.s10 != INVALID &&
      c.s11 != INVALID)
    b |= 16u;
  if (c.u11 >= 1) b |= 32u;
  return b;
}

struct VoxelFlags {
  unsigned bits;  // 1 x-edge, 2 y-edge, 4 z-edge, 8 active cube
  float px, py, pz;
  int cse;
};

// Whether voxel (j, i) of an owned plane emits, and whether its column is
// loaded: halo rows and lanes of a sharded block emit nothing, but the
// lane just past the window still loads, for its neighbour inside. WIN:
// the emission window is smaller than the array.
template <bool WIN>
__device__ __forceinline__ void in_window(const McArgs& a, int j, int i,
                                          bool in_plane, bool* owned,
                                          bool* need) {
  *owned = *need = in_plane;
  if (WIN) {
    const bool row = in_plane && j >= a.own_lo[1] && j < a.own_hi[1] &&
                     i >= a.own_lo[2];
    *owned = row && i < a.own_hi[2];
    *need = row && i <= a.own_hi[2];
  }
}

// Flags (and, with POS, payloads) of an owned voxel (k, j, i), flat id e in
// its plane, from the bits of its own column and of column i + 1 (invalid
// voxels where that is off the grid). Most voxels lie away from the
// surface and leave at the first test.
template <bool POS>
__device__ __forceinline__ VoxelFlags voxel_flags(const McArgs& a, int k,
                                                  int j, int i, int e,
                                                  unsigned col,
                                                  unsigned ncol) {
  VoxelFlags f{0u, 0.0f, 0.0f, 0.0f, 0};
  // the corners' "below iso" bits: own column in bits 0..3 (corners 0 3 4
  // 7 of CORNER_OFFSETS: (0,0,0) (0,1,0) and the same at z+1), the next
  // column in bits 4..7 (corners 1 2 5 6: (1,0,0) (1,1,0) and at z+1)
  const unsigned in8 = (col & 15u) | ((ncol & 15u) << 4);
  if (in8 == 0u || in8 == 255u) return f;  // no edge straddles, case 0 or 255
  const bool sx = ((col ^ ncol) & 1u) && i < a.nx - 1;
  const bool sy = ((col ^ (col >> 1)) & 1u) && e + a.nx < a.plane;
  const bool sz = (col ^ (col >> 2)) & 1u;
  const bool cv = (col & ncol & 16u) && (ncol & 32u);
  if (cv) {
    f.bits |= 8u;
    // the case index numbers the corners in CORNER_OFFSETS order
    if (POS)
      f.cse = (int)((in8 & 1u) | ((in8 >> 3) & 2u) | ((in8 >> 3) & 4u) |
                    ((in8 << 2) & 8u) | ((in8 << 2) & 16u) |
                    ((in8 >> 1) & 32u) | ((in8 >> 1) & 64u) |
                    ((in8 << 4) & 128u));
  }
  if (!(sx || sy || sz)) return f;

  // the cubes adjacent to this voxel's three edges
  const bool v_jm = cube_valid(a, k, j - 1, i);
  const bool v_im = cube_valid(a, k, j, i - 1);
  const bool v_jmim = cube_valid(a, k, j - 1, i - 1);
  const bool p_0 = cube_valid(a, k - 1, j, i);
  const bool p_jm = cube_valid(a, k - 1, j - 1, i);
  const bool p_im = cube_valid(a, k - 1, j, i - 1);
  // a straddling edge's two ends are inside the grid: read them again
  const float* s = a.sdf + (k * a.plane + e);

  // x-edge: adjacent cubes in (z, y) scan order (k-1,j-1) (k-1,j)
  // (k,j-1) (k,j); no-interp roles U,L,U,L
  if (sx && (p_jm || p_0 || v_jm || cv)) {
    f.bits |= 1u;
    if (POS) {
      if (a.linear) {
        f.px = edge_interp(s[0], s[1], a.cx[i], a.cx[i + 1], a.iso);
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
    if (POS) {
      if (a.linear) {
        f.py = edge_interp(s[0], s[a.nx], a.cy[j], a.cy[j + 1], a.iso);
      } else {
        const bool up = (!p_im && p_0) || (!p_im && !p_0 && !v_im && cv);
        f.py = up ? a.cy[j + 1] : a.cy[j];
      }
    }
  }
  // z-edge: (y, x) scan order (j-1,i-1) (j-1,i) (j,i-1) (j,i), all at
  // plane k; no-interp takes the lower end. Past the last plane the upper
  // end is an invalid voxel.
  if (sz && (v_jmim || v_jm || v_im || cv)) {
    f.bits |= 4u;
    if (POS) {
      if (a.linear) {
        const float z1 = a.cz[min(k + 1, a.nz - 1)];
        const float s1 = k + 1 < a.nz ? s[a.plane] : INVALID;
        f.pz = edge_interp(s[0], s1, a.cz[k], z1, a.iso);
      } else {
        f.pz = a.cz[k];
      }
    }
  }
  return f;
}

// A thread's walk over its PER voxels of a tile: flat id e and its (j, i),
// advanced by NT without a division per voxel.
struct TileWalk {
  int e, j, i, dj, di;

  __device__ TileWalk(const McArgs& a, int base)
      : e(base + (int)threadIdx.x), j(e / a.nx), i(e - j * a.nx),
        dj(NT / a.nx), di(NT - dj * a.nx) {}

  __device__ void next(const McArgs& a) {
    e += NT;
    j += dj;
    i += di;
    if (i >= a.nx) {
      i -= a.nx;
      ++j;
    }
  }
};

// The tile of this CTA: its plane k and its flat range [base, end) of
// the plane; blockIdx.x is its index in the counts and offsets.
__device__ __forceinline__ void tile_coords(const McArgs& a, int* k,
                                            int* base, int* end) {
  const int b = (int)blockIdx.x;
  *k = b / a.tiles_per_plane;
  *base = (b - *k * a.tiles_per_plane) * TILE;
  *end = min(*base + TILE, a.plane);
}

// The flags of a thread's PER voxels of the tile [base, end) of an owned
// plane k. First every thread loads the own columns of its voxels (all its
// loads are in flight together) and keeps six bits of each; a voxel gets
// column i + 1 from the next lane by a shuffle, a warp's last lane from
// the next warp's first through `first` (NGROUPS words of shared memory),
// and only the tile's last voxel loads it itself. The whole CTA calls
// this.
template <bool WIN, bool POS>
__device__ __forceinline__ void tile_flags(const McArgs& a, int k, int base,
                                           int end, unsigned* first,
                                           VoxelFlags* f) {
  const int tid = (int)threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool kn = k + 1 < a.nz;
  const TileWalk w0(a, base);
  unsigned col[PER];
  TileWalk w = w0;
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    bool owned, need;
    in_window<WIN>(a, w.j, w.i, w.e < end, &owned, &need);
    Column c = invalid_column();
    if (need) c = load_column(a, k * a.plane + w.e, w.e + a.nx < a.plane, kn);
    col[it] = column_bits(a, c);
    if (lane == 0) first[it * NWARPS + warp] = col[it];
    w.next(a);
  }
  // the voxel after the tile's last, where the plane goes on
  unsigned after = column_bits(a, invalid_column());
  if (tid == NT - 1 && base + TILE < a.plane)
    after = column_bits(
        a, load_column(a, k * a.plane + base + TILE,
                       base + TILE + a.nx < a.plane, kn));
  __syncthreads();
  w = w0;
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    unsigned ncol = __shfl_down_sync(FULL, col[it], 1);
    if (lane == 31) {
      const int g = it * NWARPS + warp + 1;
      ncol = g < NGROUPS ? first[g] : after;
    }
    // past a row's last voxel the next lane holds the next row
    if (w.i >= a.nx - 1) ncol = column_bits(a, invalid_column());
    bool owned, need;
    in_window<WIN>(a, w.j, w.i, w.e < end, &owned, &need);
    f[it] = VoxelFlags{0u, 0.0f, 0.0f, 0.0f, 0};
    if (owned) f[it] = voxel_flags<POS>(a, k, w.j, w.i, w.e, col[it], ncol);
    w.next(a);
  }
}

template <bool WIN>
__global__ void __launch_bounds__(NT)
mc_count_kernel(McArgs a, int* tile_counts) {
  __shared__ unsigned part[NWARPS];
  __shared__ unsigned first[NGROUPS];
  int k, base, end;
  tile_coords(a, &k, &base, &end);
  const int tid = (int)threadIdx.x;
  const int64_t tile = blockIdx.x;
  if (WIN && (k < a.own_lo[0] || k >= a.own_hi[0])) {
    if (tid < 4) tile_counts[tile * 4 + tid] = 0;
    return;  // a halo plane emits nothing
  }
  VoxelFlags f[PER];
  tile_flags<WIN, false>(a, k, base, end, first, f);
  // the four counts of a thread, then of a warp (at most 32 * PER = 128
  // each), ride in the four bytes of one word: the product spreads the
  // flag bits 0..3 to bit positions 0, 8, 16, 24 without a carry
  static_assert(32 * PER < 256, "a warp's count fits a byte");
  unsigned cnt = 0u;
#pragma unroll
  for (int it = 0; it < PER; ++it)
    cnt += (f[it].bits * 0x00204081u) & 0x01010101u;
  cnt = __reduce_add_sync(FULL, cnt);
  if ((tid & 31) == 0) part[tid >> 5] = cnt;
  __syncthreads();
  if (tid < 4) {
    int sum = 0;
    for (int q = 0; q < NWARPS; ++q) sum += (part[q] >> (8 * tid)) & 255u;
    tile_counts[tile * 4 + tid] = sum;
  }
}

// ---- pass 2: the scan. A tile's four counts are one int4. ----

__device__ __forceinline__ int4 add4(int4 a, int4 b) {
  return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ int4 sub4(int4 a, int4 b) {
  return make_int4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// Inclusive scan of one int4 per thread over a CTA of NW warps, in thread
// order; *total is the CTA's sum. `wsum` is NW int4 of shared memory, free
// again when the call returns.
template <int NW>
__device__ int4 block_scan_incl(int4 v, int4* wsum, int4* total) {
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int4 n = make_int4(
        __shfl_up_sync(FULL, v.x, d), __shfl_up_sync(FULL, v.y, d),
        __shfl_up_sync(FULL, v.z, d), __shfl_up_sync(FULL, v.w, d));
    if (lane >= d) v = add4(v, n);
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  int4 before = make_int4(0, 0, 0, 0), all = before;
  for (int q = 0; q < NW; ++q) {
    const int4 s = wsum[q];
    if (q < warp) before = add4(before, s);
    all = add4(all, s);
  }
  __syncthreads();
  *total = all;
  return add4(v, before);
}

// 2a: the sum of each block of SCAN_BLOCK tiles; a warp reads 32
// consecutive tiles, 512 contiguous bytes
__global__ void __launch_bounds__(SCAN_NT)
mc_scan_sums_kernel(const int4* tile_counts, int4* block_sums, int n_tiles) {
  __shared__ int4 wsum[SCAN_NT / 32];
  const int64_t base = (int64_t)blockIdx.x * SCAN_BLOCK;
  int4 acc = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int q = 0; q < SCAN_PER; ++q) {
    const int64_t t = base + q * SCAN_NT + (int)threadIdx.x;
    if (t < n_tiles) acc = add4(acc, tile_counts[t]);
  }
  int4 total;
  block_scan_incl<SCAN_NT / 32>(acc, wsum, &total);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
}

// 2b: one CTA turns the block sums into exclusive block prefixes, in
// place, 1024 at a time with a running carry, and writes the four totals
__global__ void __launch_bounds__(SCAN_TOP_NT)
mc_scan_blocks_kernel(int4* block_sums, int n_blocks, int4* totals) {
  __shared__ int4 wsum[SCAN_TOP_NT / 32];
  int4 carry = make_int4(0, 0, 0, 0);
  for (int b0 = 0; b0 < n_blocks; b0 += SCAN_TOP_NT) {
    const int b = b0 + (int)threadIdx.x;
    const int4 v = b < n_blocks ? block_sums[b] : make_int4(0, 0, 0, 0);
    int4 total;
    const int4 incl = block_scan_incl<SCAN_TOP_NT / 32>(v, wsum, &total);
    if (b < n_blocks) block_sums[b] = add4(carry, sub4(incl, v));
    carry = add4(carry, total);
  }
  if (threadIdx.x == 0) *totals = carry;
}

// 2c: every block scans its own tiles, SCAN_NT consecutive tiles at a time,
// from its block's prefix
__global__ void __launch_bounds__(SCAN_NT)
mc_scan_offsets_kernel(const int4* tile_counts, const int4* block_prefix,
                       int4* tile_offsets, int n_tiles) {
  __shared__ int4 wsum[SCAN_NT / 32];
  const int64_t base = (int64_t)blockIdx.x * SCAN_BLOCK;
  int4 carry = block_prefix[blockIdx.x];
#pragma unroll
  for (int q = 0; q < SCAN_PER; ++q) {
    const int64_t t = base + q * SCAN_NT + (int)threadIdx.x;
    const int4 v = t < n_tiles ? tile_counts[t] : make_int4(0, 0, 0, 0);
    int4 total;
    const int4 incl = block_scan_incl<SCAN_NT / 32>(v, wsum, &total);
    if (t < n_tiles) tile_offsets[t] = add4(carry, sub4(incl, v));
    carry = add4(carry, total);
  }
}

// 2d: a plane is tiles_per_plane consecutive tiles
__global__ void __launch_bounds__(SCAN_NT)
mc_plane_counts_kernel(const int4* tile_offsets, const int4* totals,
                       int4* plane_counts, int n_tiles, int tiles_per_plane,
                       int nz) {
  const int k = (int)(blockIdx.x * SCAN_NT + threadIdx.x);
  if (k >= nz) return;
  const int64_t t0 = (int64_t)k * tiles_per_plane;
  const int64_t t1 = t0 + tiles_per_plane;
  const int4 end = t1 < n_tiles ? tile_offsets[t1] : *totals;
  plane_counts[k] = sub4(end, tile_offsets[t0]);
}

template <bool WIN>
__global__ void __launch_bounds__(NT)
mc_emit_kernel(McArgs a, const int4* tile_offsets, int4 totals, int n_tiles,
               McOut o) {
  __shared__ int wtot[NGROUPS][4];   // flags of each (iteration, warp) group
  __shared__ int wbase[NGROUPS][4];  // flags of the tile before that group
  __shared__ unsigned first[NGROUPS];
  // the tile's counts, from the scan: most tiles have nothing to emit
  const int tile = (int)blockIdx.x;
  const int4 off = tile_offsets[tile];
  const int4 nxt = tile + 1 < n_tiles ? tile_offsets[tile + 1] : totals;
  if (off.x == nxt.x && off.y == nxt.y && off.z == nxt.z && off.w == nxt.w)
    return;
  int k, base, end;
  tile_coords(a, &k, &base, &end);
  const int tid = (int)threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;

  VoxelFlags f[PER];
  tile_flags<WIN, true>(a, k, base, end, first, f);
  unsigned ranks[PER];  // rank in the warp of each stream's flag, 8 bits each
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    ranks[it] = 0u;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const unsigned ball = __ballot_sync(FULL, (f[it].bits >> s) & 1u);
      ranks[it] |= (unsigned)__popc(ball & lt_mask) << (8 * s);
      if (lane == 0) wtot[it * NWARPS + warp][s] = __popc(ball);
    }
  }
  __syncthreads();
  // elements before each group in the tile: warp s scans stream s
  if (warp < 4) {
    const int mine = wtot[lane][warp];
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += n;
    }
    wbase[lane][warp] = incl - mine;
  }
  __syncthreads();

  const int offs[4] = {off.x, off.y, off.z, off.w};
  TileWalk w2(a, base);
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    if (f[it].bits) {
      // only owned voxels reach here: their global ids are in range even
      // where plane, row or lane 0 is a halo and the base is -1
      const int lin = (k + a.zb) * a.gny * a.gnx + (w2.j + a.yb) * a.gnx +
                      (w2.i + a.xb);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (!((f[it].bits >> s) & 1u)) continue;
        const int pos = offs[s] + wbase[it * NWARPS + warp][s] +
                        (int)((ranks[it] >> (8 * s)) & 0xffu);
        switch (s) {
          case 0: o.vx_pos[pos] = f[it].px; o.vx_lin[pos] = lin; break;
          case 1: o.vy_pos[pos] = f[it].py; o.vy_lin[pos] = lin; break;
          case 2: o.vz_pos[pos] = f[it].pz; o.vz_lin[pos] = lin; break;
          default: o.c_lin[pos] = lin; o.c_case[pos] = f[it].cse; break;
        }
      }
    }
    w2.next(a);
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
  if ((int64_t)nz * ny * nx >= ((int64_t)1 << 31)) return false;
  *a = McArgs{sdf, un, cx, cy, cz, nz, ny, nx, ny * nx, iso, linear, tpp,
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

// Blocks of the scan over n_tiles tiles: the scratch array holds one int4
// (16 bytes) for each.
extern "C" int vt_mc_scan_blocks(int n_tiles) {
  return (n_tiles + SCAN_BLOCK - 1) / SCAN_BLOCK;
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
// n_tiles = nz * tiles_per_plane. `scratch` holds vt_mc_scan_blocks(n_tiles)
// int4 (the block sums, then the block prefixes); it needs no clearing.
// All arrays are 16-byte aligned.
extern "C" int vt_mc_scan(const int* tile_counts, int* tile_offsets,
                          int* totals, int* plane_counts, int n_tiles,
                          int tiles_per_plane, int nz, int* scratch,
                          void* stream) {
  if (nz < 1 || tiles_per_plane < 1 || n_tiles != nz * tiles_per_plane ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = (uintptr_t)tile_counts | (uintptr_t)tile_offsets |
                         (uintptr_t)totals | (uintptr_t)plane_counts |
                         (uintptr_t)scratch;
  if (ptrs & 15u) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int4* counts = (const int4*)tile_counts;
  int4* offsets = (int4*)tile_offsets;
  int4* sums = (int4*)scratch;
  const int n_blocks = vt_mc_scan_blocks(n_tiles);
  mc_scan_sums_kernel<<<n_blocks, SCAN_NT, 0, st>>>(counts, sums, n_tiles);
  mc_scan_blocks_kernel<<<1, SCAN_TOP_NT, 0, st>>>(sums, n_blocks,
                                                   (int4*)totals);
  mc_scan_offsets_kernel<<<n_blocks, SCAN_NT, 0, st>>>(counts, sums, offsets,
                                                       n_tiles);
  mc_plane_counts_kernel<<<(nz + SCAN_NT - 1) / SCAN_NT, SCAN_NT, 0, st>>>(
      offsets, (const int4*)totals, (int4*)plane_counts, n_tiles,
      tiles_per_plane, nz);
  return (int)cudaGetLastError();
}

// Pass 3: writes each stream to buffers of exactly totals[s] elements; win
// as in vt_mc_count (the two passes must be given the same window), and
// `totals` the scan's four totals as a HOST array.
extern "C" int vt_mc_emit(const float* sdf, const int* un, const float* cx,
                          const float* cy, const float* cz, int nz, int ny,
                          int nx, float iso, int linear, const int* win,
                          const int* tile_offsets, const int* totals,
                          float* vx_pos, int* vx_lin, float* vy_pos,
                          int* vy_lin, float* vz_pos, int* vz_lin, int* c_lin,
                          int* c_case, void* stream) {
  McArgs a;
  if (!make_args(sdf, un, cx, cy, cz, nz, ny, nx, iso, linear, win, &a) ||
      totals == nullptr || ((uintptr_t)tile_offsets & 15u))
    return (int)cudaErrorInvalidValue;
  const McOut o{vx_pos, vx_lin, vy_pos, vy_lin, vz_pos, vz_lin, c_lin,
                c_case};
  const int4 tot = make_int4(totals[0], totals[1], totals[2], totals[3]);
  const int4* offsets = (const int4*)tile_offsets;
  const int grid = nz * a.tiles_per_plane;
  if (windowed(a))
    mc_emit_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
        a, offsets, tot, grid, o);
  else
    mc_emit_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(
        a, offsets, tot, grid, o);
  return (int)cudaGetLastError();
}
