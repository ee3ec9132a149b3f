// 3d lattice block-stencil matvec for Hopper (sm_90a).
//
// Replaces cracks_tpu/ops/pallas_stencil.py::_kernel3d, the Pallas TPU
// kernel that applies the stored element matrices of a uniform 3d Q1
// lattice.  For every output vertex (d, vz, vy, vx):
//
//   Y[d,v] = sum_{a,b in 8 corners, e < k_in}
//            J[lo_r + a*k_out + d, lo_c + b*k_in + e, v - o_a]
//            * X[e, v - o_a + o_b]
//
// with corner a at grid offset o_a = ((a >> 2) & 1, (a >> 1) & 1, a & 1)
// along (z, y, x), and cells outside the (GCZ, GCY, GCX) cell grid
// contributing nothing.
//
// Layout: J is the full (R, C, GCZ, GCY, GCX) element-matrix tensor,
// contiguous; the block is selected by the row/column offsets
// (lo_r, lo_c) and the component counts k_out, k_in in {1, 3}.  X is
// (k_in, GZ, GY, GX) and Y is (k_out, GZ, GY, GX), G* = GC* + 1, both
// contiguous.
//
// What bounds it: memory traffic.  Each product streams the whole
// J block once: 64*k_out*k_in planes of GCZ*GCY*GCX values.  At a
// refine-3 Sneddon 3d lattice (80^3 cells) the f32 u block is 1.18 GB,
// the f32 phase-field block 131 MB, the f64 u block 2.36 GB and the
// f64 J_pu block 786 MB, against at most 51 MB of X and Y; at
// 3.35 TB/s (H100 SXM data sheet) the f32 u block needs at least
// 352 us.  The arithmetic is 2 flops per J value, far below the card's
// compute rate.
//
// Design (simple and right first; the 2d kernel one dimension up):
// one thread per output vertex, threads adjacent along vx, so each
// J plane and each X row is read with coalesced loads; k_out
// accumulators in registers, the corner loops a, b and component loops
// d, e unrolled at compile time.  J is read exactly once in total:
// entry (row, col, cell) belongs to the one vertex cell + o_a of its
// row corner a.  X's 64-fold reuse comes from L1/L2.  A bounds check
// on the cell index replaces the TPU kernel's zero-pad ring and its
// (8, 128) margin, so no padded copy of J exists.  Every offset is
// 64-bit: the full J tensor at refine 3 holds 5.2e8 values.  The TPU
// schedule (64 double-buffered corner-pair DMAs into VMEM tiles) is
// not carried over.
//
// That design serves the f32 entry point.  The f64 entry point, which
// runs the refinement residual's products (the u block, the phase-field
// block, J_pu), launches the streaming kernel of
// lattice_stencil3d_stream.cuh instead: J through a ring of
// shared-memory slots filled by TMA (cp.async on odd rows), threads
// flattened over whole vertex rows.  Both sum in the same order and
// give the same bits.
//
// The kernel allocates nothing and runs on the caller's stream; each
// entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "lattice_stencil3d_stream.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <typename T, int KIN, int KOUT>
__global__ void __launch_bounds__(kBlockX * kBlockY)
lattice_stencil3d_kernel(const T* __restrict__ J, const T* __restrict__ X,
                         T* __restrict__ Y, int C, int GCZ, int GCY,
                         int GCX, int lo_r, int lo_c) {
  const int vx = blockIdx.x * kBlockX + threadIdx.x;
  const int vy = blockIdx.y * kBlockY + threadIdx.y;
  const int vz = blockIdx.z;
  const int GZ = GCZ + 1;
  const int GY = GCY + 1;
  const int GX = GCX + 1;
  if (vx >= GX || vy >= GY || vz >= GZ) return;
  const int64_t plane = static_cast<int64_t>(GCZ) * GCY * GCX;
  const int64_t vplane = static_cast<int64_t>(GZ) * GY * GX;

  T acc[KOUT];
#pragma unroll
  for (int d = 0; d < KOUT; ++d) acc[d] = T(0);

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int cz = vz - ((a >> 2) & 1);
    const int cy = vy - ((a >> 1) & 1);
    const int cx = vx - (a & 1);
    if (cz < 0 || cz >= GCZ || cy < 0 || cy >= GCY || cx < 0 || cx >= GCX)
      continue;
    const int64_t cell =
        (static_cast<int64_t>(cz) * GCY + cy) * GCX + cx;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int64_t xoff =
          (static_cast<int64_t>(cz + ((b >> 2) & 1)) * GY +
           (cy + ((b >> 1) & 1))) * GX + (cx + (b & 1));
#pragma unroll
      for (int e = 0; e < KIN; ++e) {
        const T xv = X[e * vplane + xoff];
        const int64_t col = lo_c + b * KIN + e;
#pragma unroll
        for (int d = 0; d < KOUT; ++d) {
          const int64_t row = lo_r + a * KOUT + d;
          acc[d] += J[(row * C + col) * plane + cell] * xv;
        }
      }
    }
  }
  const int64_t out = (static_cast<int64_t>(vz) * GY + vy) * GX + vx;
#pragma unroll
  for (int d = 0; d < KOUT; ++d) Y[d * vplane + out] = acc[d];
}

template <typename T, int KIN, int KOUT>
void launch(const T* J, const T* X, T* Y, int C, int GCZ, int GCY, int GCX,
            int lo_r, int lo_c, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((GCX + 1 + kBlockX - 1) / kBlockX,
                  (GCY + 1 + kBlockY - 1) / kBlockY, GCZ + 1);
  lattice_stencil3d_kernel<T, KIN, KOUT><<<grid, block, 0, stream>>>(
      J, X, Y, C, GCZ, GCY, GCX, lo_r, lo_c);
}

template <typename T>
int dispatch(const T* J, const T* X, T* Y, int R, int C, int GCZ, int GCY,
             int GCX, int lo_r, int lo_c, int k_in, int k_out,
             void* stream_ptr) {
  (void)R;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k_in == 3 && k_out == 3) {
    launch<T, 3, 3>(J, X, Y, C, GCZ, GCY, GCX, lo_r, lo_c, stream);
  } else if (k_in == 1 && k_out == 1) {
    launch<T, 1, 1>(J, X, Y, C, GCZ, GCY, GCX, lo_r, lo_c, stream);
  } else if (k_in == 3 && k_out == 1) {
    launch<T, 3, 1>(J, X, Y, C, GCZ, GCY, GCX, lo_r, lo_c, stream);
  } else if (k_in == 1 && k_out == 3) {
    launch<T, 1, 3>(J, X, Y, C, GCZ, GCY, GCX, lo_r, lo_c, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lattice_stencil3d_f32(const float* J, const float* X,
                                     float* Y, int R, int C, int GCZ,
                                     int GCY, int GCX, int lo_r, int lo_c,
                                     int k_in, int k_out, void* stream) {
  return dispatch<float>(J, X, Y, R, C, GCZ, GCY, GCX, lo_r, lo_c, k_in,
                         k_out, stream);
}

// Ring slots and tile rows of the streaming kernel per (k_in, k_out):
// for the three blocks the main path launches, the fastest of the
// variants scripts/tune_stencil3d_f64.py timed on an H100 at 80^3
// cells; J_up, which it does not launch, within 2 % of its fastest.
extern "C" int lattice_stencil3d_f64(const double* J, const double* X,
                                     double* Y, int R, int C, int GCZ,
                                     int GCY, int GCX, int lo_r, int lo_c,
                                     int k_in, int k_out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k_in == 3 && k_out == 3) {
    return stream3d::launch<3, 3, 1>(J, X, Y, R, C, GCZ, GCY, GCX, lo_r,
                                     lo_c, 3, stream);
  }
  if (k_in == 1 && k_out == 1) {
    return stream3d::launch<1, 1, 1>(J, X, Y, R, C, GCZ, GCY, GCX, lo_r,
                                     lo_c, 2, stream);
  }
  if (k_in == 3 && k_out == 1) {
    return stream3d::launch<3, 1, 1>(J, X, Y, R, C, GCZ, GCY, GCX, lo_r,
                                     lo_c, 3, stream);
  }
  if (k_in == 1 && k_out == 3) {
    return stream3d::launch<1, 3, 2>(J, X, Y, R, C, GCZ, GCY, GCX, lo_r,
                                     lo_c, 2, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
