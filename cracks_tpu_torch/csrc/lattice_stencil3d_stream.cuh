// The f64 3d lattice block-stencil product for Hopper (sm_90a), as a
// stream: J flows through a ring of shared-memory stages filled by
// asynchronous copies that complete on mbarriers.  Included by
// lattice_stencil3d.cu, whose f64 entry point launches it for every f64
// 3d product of the solve (the u block, the phase-field block and the
// J_pu / J_up couplings of the refinement residual); its f32 entry
// point keeps the one-thread-per-vertex kernel there.
//
// Function (the same as lattice_stencil3d.cu's): for every output
// vertex (d, vz, vy, vx)
//
//   Y[d,v] = sum_{a,b in 8 corners, e < k_in}
//            J[lo_r + a*k_out + d, lo_c + b*k_in + e, v - o_a]
//            * X[e, v - o_a + o_b]
//
// on the full, contiguous J (R, C, GCZ, GCY, GCX), with X (k_in, GZ,
// GY, GX) and Y (k_out, GZ, GY, GX), G* = GC* + 1.  It replaces, for
// f64, the Pallas TPU kernel cracks_tpu/ops/pallas_stencil.py::_kernel3d
// (:232); in the JAX package these f64 products are the XLA einsum
// cracks_tpu/solvers/lattice.py::matvec_block.
//
// What bounds it: memory traffic.  Each J value is read once and used
// once (2 flops), so the product streams the J block: 2.36 GB for the
// u block and 786 MB for J_pu at 80^3 cells in f64, at least 712 us
// and 240 us at 3.35 TB/s (H100 SXM data sheet); X and Y add 1 %.  The
// one-thread-per-vertex kernel keeps its bytes in flight in registers
// (192 loads a thread in J_pu, 576 in the u block) and idles 16 % of its
// lanes in x at 81 vertices per row.
//
// Design: a CTA owns one output plane vz and TY rows of TXV vertices
// (the whole row where it holds at most kMaxRow vertices, else tiles of
// kSplitRow); its threads are flattened over the TY*TXV tile vertices,
// so no lane is launched for nothing but the last warp's tail.  The
// stages of the stream are the (row corner a, output component d)
// pairs, 8*k_out of them: stage (a, d) is J row lo_r + a*k_out + d, its
// 8*k_in block columns (consecutive planes of J) at the tile's cells
// (vz - oz, vy0 - oy .. vy0 - oy + TY - 1, the row's x cells): one box
// of J, 8*k_in runs of TY*GCX contiguous values (15 KB per tile row in
// the u block and J_pu, 5 KB in the phase-field block).  Where J's rows
// are 16-byte strided (even GCX, J on 16 bytes: the main path) one
// thread asks TMA for the whole box; cells past the lattice's edges
// come in as zeros and are not read.  Otherwise (odd GCX) every thread
// copies 8 bytes at a time with cp.async, the cells inside the lattice
// only, and arrives on the stage's barrier when its copies land.  The
// boxes go through a ring of STAGES shared-memory slots completed on
// mbarriers; a slot is refilled once every thread is done with it.  On
// the H100 a shallow ring in small CTAs, several on each SM, beats a
// deep one (scripts/tune_stencil3d_f64.py): the u block and J_pu take
// one slot of 3 tile rows.  The X tile (k_in * 3 planes * (TY + 2) rows
// * (TXV + 2) vertices, the one-vertex ring included) is read once per
// CTA with plain loads while the first boxes are in flight (X rows of
// 81 values are not 16-byte aligned); a corner's 8*k_in X values are
// held in registers across its k_out components.
//
// Order of terms: for each output vertex and component d the sum runs
// over a, then b, then e, skips the corners whose cell lies outside the
// lattice and adds in the acc += J * x form, as lattice_stencil3d.cu's
// f32 kernel and lattice_stencil_sharded.cuh do: on the same inputs the
// three give the same bits.  Offsets into J are 64-bit (the full f64 J
// at refine 3 holds 5.2e8 values).  The tensor map is encoded on the
// host at each launch.  The kernel allocates nothing and runs on the
// caller's stream.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "lattice_stencil_sharded.cuh"   // mbarrier and TMA helpers

// Internal linkage, as in lattice_stencil_sharded.cuh: each library that
// includes this header keeps its own instances and their statics.
namespace {
namespace stream3d {

using sharded::encode_fn;
using sharded::fence_barrier_init;
using sharded::mbar_expect_tx;
using sharded::mbar_init;
using sharded::mbar_wait;
using sharded::smem_addr;
using sharded::tma_load5;

constexpr int kMaxThreads = 512;   // threads of a CTA, at most
constexpr int kMaxRow = 256;       // a tile holds a whole row up to this
constexpr int kSplitRow = 128;     // else rows are cut into such tiles

// One 8-byte asynchronous copy, and the arrival on `bar` of this
// thread's copies once they have landed (counted as one of the
// barrier's expected arrivals).
__device__ __forceinline__ void copy8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// Corner a's offsets along z, y, x: the bit order of
// lattice_stencil3d.cu.
__host__ __device__ constexpr int oz(int a) { return (a >> 2) & 1; }
__host__ __device__ constexpr int oy(int a) { return (a >> 1) & 1; }
__host__ __device__ constexpr int ox(int a) { return a & 1; }

// A launch's tile: TY rows of TXV vertices.  A stage holds, per block
// column, TY cell rows of W cells from cell bx = max(vx0 - 2, 0) (W =
// GCX for whole rows, else kSplitRow + 2: the tile's cells vx0 - 1 ..
// vx0 + TXV - 1 from a 16-byte aligned origin), `stage` values apart (a
// multiple of 128 bytes); X has `xt` values per component.
struct Geometry {
  int txv, ty, w, threads, stage, xt;
  size_t smem;
};

template <int KIN, int KOUT, int STAGES, bool TMA>
__global__ void __launch_bounds__(kMaxThreads)
lattice_stencil3d_stream_kernel(const __grid_constant__ CUtensorMap jmap,
                                const double* __restrict__ J,
                                const double* __restrict__ X,
                                double* __restrict__ Y, int C, int GCZ,
                                int GCY, int GCX, int lo_r, int lo_c,
                                Geometry g) {
  constexpr int NP = 8 * KIN;           // block columns: J planes
  constexpr int NS = 8 * KOUT;          // stages: (a, d)
  static_assert(STAGES >= 1 && STAGES <= NS && STAGES <= 16, "ring");
  const int GZ = GCZ + 1;
  const int GY = GCY + 1;
  const int GX = GCX + 1;
  const int vz = blockIdx.z;
  const int vy0 = blockIdx.y * g.ty;
  const int vx0 = blockIdx.x * g.txv;
  const int bx = max(vx0 - 2, 0);
  const int64_t vplane = static_cast<int64_t>(GZ) * GY * GX;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  double* ring = reinterpret_cast<double*>(base + 128);
  double* xs = ring + STAGES * g.stage;

  // stage s = (a, d) into ring slot st: J row lo_r + a*KOUT + d, block
  // columns lo_c .., cells (vz - oz, vy0 - oy .., bx ..)
  auto issue = [&](int s, int st) {
    const int a = s / KOUT;
    const int row = lo_r + s;           // lo_r + a*KOUT + d
    const int cz = vz - oz(a);
    const int cy0 = vy0 - oy(a);
    double* dst = ring + st * g.stage;
    if constexpr (TMA) {
      // a box with no cell inside the lattice is not asked for: the
      // arrival alone completes the stage
      if (cz < 0 || cz >= GCZ || cy0 + g.ty <= 0 || cy0 >= GCY) {
        mbar_expect_tx(&bar[st], 0);
        return;
      }
      mbar_expect_tx(&bar[st], static_cast<uint32_t>(
                                   NP * g.ty * g.w * sizeof(double)));
      tma_load5(dst, &jmap, &bar[st], bx, cy0, cz, lo_c, row);
    } else {
      // the cell rows inside the lattice, one warp per row
      const int y_lo = max(cy0, 0);
      const int ny = cz >= 0 && cz < GCZ ? min(cy0 + g.ty, GCY) - y_lo : 0;
      const int x_lo = max(vx0 - 1, 0);
      const int nx = min(vx0 + g.txv - 1, GCX - 1) - x_lo + 1;
      const int64_t plane = static_cast<int64_t>(GCZ) * GCY * GCX;
      for (int seg = threadIdx.x >> 5; seg < NP * ny;
           seg += blockDim.x >> 5) {
        const int c = seg / ny;
        const int y = y_lo + seg % ny;
        const double* src =
            J + (static_cast<int64_t>(row) * C + lo_c + c) * plane +
            (static_cast<int64_t>(cz) * GCY + y) * GCX + x_lo;
        double* d = dst + (c * g.ty + y - cy0) * g.w + x_lo - bx;
        for (int u = threadIdx.x & 31; u < nx; u += 32) copy8(d + u, src + u);
      }
      arrive_on_copies(&bar[st]);
    }
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st)
      mbar_init(&bar[st], TMA ? 1 : blockDim.x);
    fence_barrier_init();
  }
  __syncthreads();
  if (!TMA || threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) issue(s, s);
  }

  // X's tile: planes vz-1..vz+1, rows vy0-1..vy0+TY, vertices
  // vx0-1..vx0+TXV, zero outside the lattice; one warp per row
  const int xw = g.txv + 2;
  const int xrows = g.ty + 2;
  for (int seg = threadIdx.x >> 5; seg < KIN * 3 * xrows;
       seg += blockDim.x >> 5) {
    const int e = seg / (3 * xrows);
    const int zz = vz - 1 + (seg / xrows) % 3;
    const int yy = vy0 - 1 + seg % xrows;
    const bool in = zz >= 0 && zz < GZ && yy >= 0 && yy < GY;
    const double* src =
        X + e * vplane + (static_cast<int64_t>(zz) * GY + yy) * GX;
    double* dst = xs + e * g.xt + (seg % (3 * xrows)) * xw;
    for (int u = threadIdx.x & 31; u < xw; u += 32) {
      const int xx = vx0 - 1 + u;
      dst[u] = in && xx >= 0 && xx < GX ? src[xx] : 0.0;
    }
  }
  __syncthreads();

  // this thread's output vertex
  const int ty = threadIdx.x / g.txv;
  const int tx = threadIdx.x - ty * g.txv;
  const int vy = vy0 + ty;
  const int vx = vx0 + tx;
  const bool live = ty < g.ty && vy < GY && vx < GX;
  const int pstride = g.ty * g.w;   // a block column in a stage

  double acc[KOUT];
#pragma unroll
  for (int d = 0; d < KOUT; ++d) acc[d] = 0.0;
  double xr[NP];

#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int st = s % STAGES;
    mbar_wait(&bar[st], (s / STAGES) & 1);
    const int a = s / KOUT;
    const int d = s % KOUT;
    const int cz = vz - oz(a);
    const int cy = vy - oy(a);
    const int cx = vx - ox(a);
    if (live && cz >= 0 && cz < GCZ && cy >= 0 && cy < GCY && cx >= 0 &&
        cx < GCX) {
      if (d == 0) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int xi = ((1 - oz(a) + oz(b)) * xrows + ty + 1 - oy(a) +
                          oy(b)) * xw + tx + 1 - ox(a) + ox(b);
#pragma unroll
          for (int e = 0; e < KIN; ++e) xr[b * KIN + e] = xs[e * g.xt + xi];
        }
      }
      const double* Js = ring + st * g.stage + ty * g.w + (cx - bx);
#pragma unroll
      for (int c = 0; c < NP; ++c) acc[d] += Js[c * pstride] * xr[c];
    }
    if (s + STAGES < NS) {
      __syncthreads();                  // every thread is done with st
      if (!TMA || threadIdx.x == 0) issue(s + STAGES, st);
    }
  }
  if (live) {
    const int64_t out = (static_cast<int64_t>(vz) * GY + vy) * GX + vx;
#pragma unroll
    for (int d = 0; d < KOUT; ++d) Y[d * vplane + out] = acc[d];
  }
}

// The tile of a launch with `ty` rows asked for: whole rows up to
// kMaxRow vertices, else kSplitRow; fewer rows where the CTA would pass
// kMaxThreads threads.
template <int KIN, int STAGES>
Geometry geometry(int GCX, int ty) {
  Geometry g;
  const bool whole = GCX + 1 <= kMaxRow;
  g.txv = whole ? GCX + 1 : kSplitRow;
  g.w = whole ? GCX : kSplitRow + 2;
  g.ty = ty < 1 ? 1 : ty;
  while (g.ty > 1 && g.txv * g.ty > kMaxThreads) --g.ty;
  g.threads = (g.txv * g.ty + 31) / 32 * 32;
  const int per128 = 128 / sizeof(double);
  g.stage = (8 * KIN * g.ty * g.w + per128 - 1) / per128 * per128;
  g.xt = 3 * (g.ty + 2) * (g.txv + 2);
  // 128 bytes of alignment slack, 128 for the barriers, the ring, X
  g.smem = 256 + (static_cast<size_t>(STAGES) * g.stage +
                  static_cast<size_t>(KIN) * g.xt) * sizeof(double);
  return g;
}

// The shared memory a kernel may use, raised once per instance.
template <int KIN, int KOUT, int STAGES, bool TMA>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      lattice_stencil3d_stream_kernel<KIN, KOUT, STAGES, TMA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <int KIN, int KOUT, int STAGES, bool TMA>
int launch_path(const CUtensorMap& map, const double* J, const double* X,
                double* Y, int C, int GCZ, int GCY, int GCX, int lo_r,
                int lo_c, const Geometry& g, cudaStream_t stream) {
  cudaError_t err = allow_smem<KIN, KOUT, STAGES, TMA>(g.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((GCX + 1 + g.txv - 1) / g.txv,
                  (GCY + 1 + g.ty - 1) / g.ty, GCZ + 1);
  lattice_stencil3d_stream_kernel<KIN, KOUT, STAGES, TMA>
      <<<grid, g.threads, g.smem, stream>>>(map, J, X, Y, C, GCZ, GCY, GCX,
                                            lo_r, lo_c, g);
  return static_cast<int>(cudaGetLastError());
}

// One product with STAGES ring slots and tiles of `ty` rows: TMA boxes
// where J's rows are 16-byte strided (even GCX, J on 16 bytes) unless
// `copies8` asks for the 8-byte copies, which take any grid.  Returns a
// CUDA runtime error code (0: launched), -1 when the driver has no
// cuTensorMapEncodeTiled, -(1000 + CUresult) when the encoding fails.
template <int KIN, int KOUT, int STAGES>
int launch(const double* J, const double* X, double* Y, int R, int C,
           int GCZ, int GCY, int GCX, int lo_r, int lo_c, int ty,
           cudaStream_t stream, bool copies8 = false) {
  static_assert(kSplitRow % 2 == 0 && kSplitRow + 2 <= 256, "TMA box");
  const Geometry g = geometry<KIN, STAGES>(GCX, ty);
  CUtensorMap map{};
  if (copies8 || GCX % 2 != 0 ||
      reinterpret_cast<uintptr_t>(J) % 16 != 0) {
    return launch_path<KIN, KOUT, STAGES, false>(
        map, J, X, Y, C, GCZ, GCY, GCX, lo_r, lo_c, g, stream);
  }
  sharded::EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return -1;
  // J's dims, innermost first: x, y, z cells, block columns, rows
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(GCX),
                              static_cast<cuuint64_t>(GCY),
                              static_cast<cuuint64_t>(GCZ),
                              static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(R)};
  cuuint64_t strides[4];
  cuuint64_t stride = sizeof(double);
  for (int i = 0; i < 4; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(g.w),
                             static_cast<cuuint32_t>(g.ty), 1, 8 * KIN, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 5, const_cast<double*>(J),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -(1000 + static_cast<int>(res));
  return launch_path<KIN, KOUT, STAGES, true>(
      map, J, X, Y, C, GCZ, GCY, GCX, lo_r, lo_c, g, stream);
}

}  // namespace stream3d
}  // namespace
