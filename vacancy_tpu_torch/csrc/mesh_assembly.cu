// Marching-cubes mesh assembly on the card, from kernel B's streams.
//
// Kernel B (mc_fused.cu) leaves four compacted streams in flat (z, y, x)
// order: the x/y/z canonical-edge vertices (position along the edge, owner
// lin) and the active cubes (lin, case). These kernels turn them into the
// finished mesh where they lie, with the bytes of the host's plain assembly
// (ops/mc_fused.assemble_fused_streams with native=False):
//   vertices f32[V, 3], V = nvx + nvy + nvz, all x-edge vertices, then y,
//     then z: the interpolated coordinate is the stream's position, the two
//     fixed ones the grid's axis centres at the owner's (i, j, k);
//   faces i32[F, 3], cube-major then by table slot: cube c's TRI_COUNT[case]
//     faces start at the exclusive prefix of the triangle counts, and face
//     t's vertex j is table slot 3t + (2 - j) (the reference's reversed
//     winding). Each corner's canonical edge (axis, owner lin = cube lin +
//     the edge's owner offset, in int64) resolves to bases[axis] +
//     lower_bound(v{axis}_lin, key): the lin streams ascend by construction.
// Passes:
//   mesh_vertices_kernel: one thread per vertex, elementwise;
//   mesh_tri_sums_kernel: one CTA per CUBES_PER_CTA cubes sums the cubes'
//     triangle counts;
//   mesh_tri_scan_kernel: one CTA turns those sums into exclusive int64
//     prefixes in place and writes the total, which the caller reads back to
//     size the faces;
//   mesh_faces_kernel: one thread per cube scans its CTA's triangle counts
//     from the CTA's prefix and writes its faces.
// The tables (TRI_TABLE, TRI_COUNT, EDGE_AXIS and each edge's owner offset
// (dx, dy, dz)) come in one int32 array that the caller filled from
// ops/mc_tables.py and keeps on the card (layout: the T_* offsets below).
//
// What bounds it on the card: bytes, read once and written once -- 8 B per
// vertex and per cube read, 12 B per vertex and per face written, some
// 25-35 MB at 512^3 (~10 us at 3.35 TB/s). The face pass also walks three
// binary searches per face over streams that sit in L2; a warp's 32
// consecutive cubes share the first steps of their searches. The finished
// mesh's copy to the host, not these kernels, bounds the layer.
//
// Numerics: no arithmetic on the values; vertices are copies of the stream
// positions and the centre arrays' floats. Each C entry point returns
// cudaError_t and launches nothing for an empty input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                // threads per CTA of every pass
constexpr int CUBES_PER_CTA = NT;      // one cube per thread
constexpr int SCAN_NT = 1024;          // the one CTA over the CTA sums
constexpr int T_TRI = 0;               // TRI_TABLE, [256][16]
constexpr int T_COUNT = T_TRI + 256 * 16;   // TRI_COUNT, [256]
constexpr int T_AXIS = T_COUNT + 256;       // EDGE_AXIS, [12]
constexpr int T_OFF = T_AXIS + 12;          // edge owner (dx, dy, dz), [12][3]
constexpr int T_INTS = T_OFF + 12 * 3;
constexpr unsigned FULL = 0xffffffffu;

// exclusive scan of v over the CTA of NT threads; *total gets the sum
__device__ __forceinline__ int cta_scan_excl(int v, int* wsum, int* total) {
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += n;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < NT / 32 ? wsum[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(FULL, wi, d);
      if (lane >= d) wi += n;
    }
    if (lane < NT / 32) wsum[lane] = wi - w;
    if (lane == NT / 32 - 1) wsum[NT / 32] = wi;
  }
  __syncthreads();
  *total = wsum[NT / 32];
  return wsum[warp] + incl - v;
}

__device__ __forceinline__ int tri_count(const int* __restrict__ tables,
                                         const int* __restrict__ c_case,
                                         int64_t c, int nc) {
  return c < nc ? __ldg(tables + T_COUNT + __ldg(c_case + c)) : 0;
}

// first index of a[0, n) whose value is not below key
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int64_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if ((int64_t)__ldg(a + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

struct Streams {
  const float* pos[3];
  const int* lin[3];
  int n[3];
};

// s.lin[a] and s.n[a] by selects, so that no array is indexed at run time
__device__ __forceinline__ const int* lin_of(const Streams& s, int a) {
  return a == 0 ? s.lin[0] : a == 1 ? s.lin[1] : s.lin[2];
}
__device__ __forceinline__ int n_of(const Streams& s, int a) {
  return a == 0 ? s.n[0] : a == 1 ? s.n[1] : s.n[2];
}

__global__ void __launch_bounds__(NT)
mesh_vertices_kernel(Streams s, const float* __restrict__ cx,
                     const float* __restrict__ cy,
                     const float* __restrict__ cz, int ny, int nx,
                     float* __restrict__ verts) {
  const int64_t v_id = (int64_t)blockIdx.x * NT + threadIdx.x;
  int64_t t = v_id;
  int a = 0;
  if (t >= s.n[0]) { t -= s.n[0]; a = 1; }
  if (a == 1 && t >= s.n[1]) { t -= s.n[1]; a = 2; }
  if (a == 2 && t >= s.n[2]) return;
  const int lin = __ldg(lin_of(s, a) + t);
  const float* pos = a == 0 ? s.pos[0] : a == 1 ? s.pos[1] : s.pos[2];
  const float p = __ldg(pos + t);
  const int i = lin % nx, j = (lin / nx) % ny, k = lin / nx / ny;
  float* v = verts + 3 * v_id;
  v[0] = a == 0 ? p : __ldg(cx + i);
  v[1] = a == 1 ? p : __ldg(cy + j);
  v[2] = a == 2 ? p : __ldg(cz + k);
}

__global__ void __launch_bounds__(NT)
mesh_tri_sums_kernel(const int* __restrict__ c_case, int nc,
                     const int* __restrict__ tables, int64_t* cta_sums) {
  __shared__ int wsum[NT / 32 + 1];
  const int64_t c = (int64_t)blockIdx.x * CUBES_PER_CTA + threadIdx.x;
  int total;
  cta_scan_excl(tri_count(tables, c_case, c, nc), wsum, &total);
  if (threadIdx.x == 0) cta_sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(SCAN_NT)
mesh_tri_scan_kernel(int64_t* cta_sums, int n_ctas, int64_t* total) {
  __shared__ int64_t wsum[SCAN_NT / 32];
  __shared__ int64_t round_end;
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
  int64_t carry = 0;
  for (int b0 = 0; b0 < n_ctas; b0 += SCAN_NT) {
    const int b = b0 + (int)threadIdx.x;
    const int64_t v = b < n_ctas ? cta_sums[b] : 0;
    int64_t incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t n = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += n;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int64_t w = wsum[lane];  // SCAN_NT / 32 == 32 warps
      int64_t wi = w;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int64_t n = __shfl_up_sync(FULL, wi, d);
        if (lane >= d) wi += n;
      }
      wsum[lane] = wi - w;
    }
    __syncthreads();
    const int64_t before = carry + wsum[warp] + incl - v;
    if (b < n_ctas) cta_sums[b] = before;
    // the carry into the next round: the last thread's inclusive prefix
    if (threadIdx.x == SCAN_NT - 1) round_end = before + v;
    __syncthreads();
    carry = round_end;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(NT)
mesh_faces_kernel(const int* __restrict__ c_lin,
                  const int* __restrict__ c_case, int nc,
                  const int64_t* __restrict__ cta_prefix,
                  const int* __restrict__ tables, Streams s, int ny, int nx,
                  int* __restrict__ faces) {
  __shared__ int wsum[NT / 32 + 1];
  const int64_t c = (int64_t)blockIdx.x * CUBES_PER_CTA + threadIdx.x;
  const int n = tri_count(tables, c_case, c, nc);
  int cta_total;
  const int excl = cta_scan_excl(n, wsum, &cta_total);
  if (n == 0) return;
  const int64_t first = cta_prefix[blockIdx.x] + excl;
  const int* row = tables + T_TRI + 16 * __ldg(c_case + c);
  const int64_t lin = __ldg(c_lin + c);
  const int64_t plane = (int64_t)ny * nx;
  int* out = faces + 3 * first;
  for (int t = 0; t < n; ++t) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int e = __ldg(row + 3 * t + (2 - j));
      const int a = __ldg(tables + T_AXIS + e);
      const int* off = tables + T_OFF + 3 * e;
      const int64_t key = lin + __ldg(off + 2) * plane +
                          (int64_t)__ldg(off + 1) * nx + __ldg(off);
      const int64_t base = a == 0 ? 0 : a == 1 ? (int64_t)s.n[0]
                                               : (int64_t)s.n[0] + s.n[1];
      out[3 * t + j] =
          (int)(base + lower_bound(lin_of(s, a), n_of(s, a), key));
    }
  }
}

int n_ctas(int64_t n) { return (int)((n + NT - 1) / NT); }

Streams make_streams(const float* vx_pos, const int* vx_lin, int nvx,
                     const float* vy_pos, const int* vy_lin, int nvy,
                     const float* vz_pos, const int* vz_lin, int nvz) {
  return Streams{{vx_pos, vy_pos, vz_pos}, {vx_lin, vy_lin, vz_lin},
                 {nvx, nvy, nvz}};
}

}  // namespace

// What the caller sizes from this file: i = 0, the cubes per CTA of the
// face passes (cta_sums holds one int64 per CTA); i = 1, the int32s of the
// tables array (the T_* layout).
extern "C" int vt_mesh_layout(int i) {
  return i == 0 ? CUBES_PER_CTA : i == 1 ? T_INTS : -1;
}

// verts is f32[nvx + nvy + nvz, 3]; cx, cy, cz the grid's axis centres.
extern "C" int vt_mesh_vertices(const float* vx_pos, const int* vx_lin,
                                int nvx, const float* vy_pos,
                                const int* vy_lin, int nvy,
                                const float* vz_pos, const int* vz_lin,
                                int nvz, const float* cx, const float* cy,
                                const float* cz, int ny, int nx,
                                float* verts, void* stream) {
  if (nvx < 0 || nvy < 0 || nvz < 0 || ny < 1 || nx < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t nv = (int64_t)nvx + nvy + nvz;
  if (nv == 0) return (int)cudaSuccess;
  if (nv >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  mesh_vertices_kernel<<<n_ctas(nv), NT, 0, (cudaStream_t)stream>>>(
      make_streams(vx_pos, vx_lin, nvx, vy_pos, vy_lin, nvy, vz_pos, vz_lin,
                   nvz),
      cx, cy, cz, ny, nx, verts);
  return (int)cudaGetLastError();
}

// The faces' offsets: cta_sums (one int64 per CTA of CUBES_PER_CTA cubes)
// becomes each CTA's exclusive prefix of the triangle counts, *total (one
// int64 on the card) the face count.
extern "C" int vt_mesh_face_offsets(const int* c_case, int nc,
                                    const int* tables, int64_t* cta_sums,
                                    int64_t* total, void* stream) {
  if (nc < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (nc == 0) return (int)cudaMemsetAsync(total, 0, sizeof(int64_t), st);
  const int ctas = n_ctas(nc);
  mesh_tri_sums_kernel<<<ctas, NT, 0, st>>>(c_case, nc, tables, cta_sums);
  mesh_tri_scan_kernel<<<1, SCAN_NT, 0, st>>>(cta_sums, ctas, total);
  return (int)cudaGetLastError();
}

// faces is i32[F, 3], F the total of vt_mesh_face_offsets, whose cta_sums
// (now the prefixes) it takes.
extern "C" int vt_mesh_faces(const int* c_lin, const int* c_case, int nc,
                             const int64_t* cta_prefix, const int* tables,
                             const int* vx_lin, int nvx, const int* vy_lin,
                             int nvy, const int* vz_lin, int nvz, int ny,
                             int nx, int* faces, void* stream) {
  if (nc < 0 || nvx < 0 || nvy < 0 || nvz < 0 || ny < 1 || nx < 1)
    return (int)cudaErrorInvalidValue;
  if (nc == 0) return (int)cudaSuccess;
  mesh_faces_kernel<<<n_ctas(nc), NT, 0, (cudaStream_t)stream>>>(
      c_lin, c_case, nc, cta_prefix, tables,
      make_streams(nullptr, vx_lin, nvx, nullptr, vy_lin, nvy, nullptr,
                   vz_lin, nvz),
      ny, nx, faces);
  return (int)cudaGetLastError();
}
