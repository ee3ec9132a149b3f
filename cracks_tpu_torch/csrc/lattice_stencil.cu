// Lattice block-stencil matvec for Hopper (sm_90a).
//
// Replaces cracks_tpu/ops/pallas_stencil.py::_kernel, the Pallas TPU
// kernel that applies the stored element matrices of a uniform 2d Q1
// lattice.  For every output vertex (d, vy, vx):
//
//   Y[d,vy,vx] = sum_{a,b in 4 corners, e < k_in}
//                J[lo_r + a*k_out + d, lo_c + b*k_in + e, vy-oy_a, vx-ox_a]
//                * X[e, vy-oy_a+oy_b, vx-ox_a+ox_b]
//
// with corner a at grid offset (oy_a, ox_a) = (a >> 1, a & 1), and
// cells outside the (GCY, GCX) cell grid contributing nothing.
//
// Layout: J is the full (R, C, GCY, GCX) element-matrix tensor,
// contiguous; the block is selected by the row/column offsets
// (lo_r, lo_c) and the component counts k_out, k_in in {1, 2}.
// X is (k_in, GY, GX) and Y is (k_out, GY, GX), GY = GCY+1,
// GX = GCX+1, both contiguous.
//
// What bounds it: memory traffic.  Each product streams the whole
// J block once: 16*k_out*k_in planes of GCY*GCX values (the u block of
// a refine-6 Sneddon lattice, 640x640 cells, is 104.9 MB in f32 and
// 210 MB in f64; the phase-field block 26.2 MB in f32) against a few
// MB of X and Y.  At 3.35 TB/s (H100 SXM data sheet) the floor for
// the f32 u block is about 33 us; the arithmetic is 2 flops per J
// value, far below the card's compute rate.
//
// Design (simple and right first): one thread per output vertex,
// threads adjacent along vx, so each J plane and X row is read with
// coalesced loads; loops over corners a, b and components d, e are
// unrolled at compile time.  J is read exactly once in total: entry
// (row, col, cy, cx) belongs to the one vertex (cy+oy_a, cx+ox_a) of
// its row corner a.  X's 16-fold reuse comes from L1/L2.  A bounds
// check on the cell index replaces the TPU kernel's zero-pad ring, so
// no padded copy of J exists.  This kernel runs the k = 2 products
// (the u block and the J_pu coupling); the phase-field block (k_in =
// k_out = 1) goes to the kernel of lattice_stencil2d_phi.cuh (16-byte
// J loads, X staged in shared memory), which sums in the same order.
//
// The kernel allocates nothing and runs on the caller's stream; each
// entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "lattice_stencil2d_phi.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <typename T, int KIN, int KOUT>
__global__ void __launch_bounds__(kBlockX * kBlockY)
lattice_stencil_kernel(const T* __restrict__ J, const T* __restrict__ X,
                       T* __restrict__ Y, int C, int GCY, int GCX,
                       int lo_r, int lo_c) {
  const int vx = blockIdx.x * kBlockX + threadIdx.x;
  const int vy = blockIdx.y * kBlockY + threadIdx.y;
  const int GY = GCY + 1;
  const int GX = GCX + 1;
  if (vx >= GX || vy >= GY) return;
  const int64_t plane = static_cast<int64_t>(GCY) * GCX;
  const int64_t vplane = static_cast<int64_t>(GY) * GX;

  T acc[KOUT];
#pragma unroll
  for (int d = 0; d < KOUT; ++d) acc[d] = T(0);

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int cy = vy - (a >> 1);
    const int cx = vx - (a & 1);
    if (cy < 0 || cy >= GCY || cx < 0 || cx >= GCX) continue;
    const int64_t cell = static_cast<int64_t>(cy) * GCX + cx;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t xoff =
          static_cast<int64_t>(cy + (b >> 1)) * GX + (cx + (b & 1));
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
  const int64_t out = static_cast<int64_t>(vy) * GX + vx;
#pragma unroll
  for (int d = 0; d < KOUT; ++d) Y[d * vplane + out] = acc[d];
}

template <typename T, int KIN, int KOUT>
void launch(const T* J, const T* X, T* Y, int C, int GCY, int GCX,
            int lo_r, int lo_c, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((GCX + 1 + kBlockX - 1) / kBlockX,
                  (GCY + 1 + kBlockY - 1) / kBlockY);
  lattice_stencil_kernel<T, KIN, KOUT><<<grid, block, 0, stream>>>(
      J, X, Y, C, GCY, GCX, lo_r, lo_c);
}

template <typename T>
int dispatch(const T* J, const T* X, T* Y, int R, int C, int GCY, int GCX,
             int lo_r, int lo_c, int k_in, int k_out, void* stream_ptr) {
  (void)R;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k_in == 2 && k_out == 2) {
    launch<T, 2, 2>(J, X, Y, C, GCY, GCX, lo_r, lo_c, stream);
  } else if (k_in == 1 && k_out == 1) {
    return phi2d::launch<T>(J, X, Y, C, GCY, GCX, lo_r, lo_c, stream);
  } else if (k_in == 2 && k_out == 1) {
    launch<T, 2, 1>(J, X, Y, C, GCY, GCX, lo_r, lo_c, stream);
  } else if (k_in == 1 && k_out == 2) {
    launch<T, 1, 2>(J, X, Y, C, GCY, GCX, lo_r, lo_c, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lattice_stencil_f32(const float* J, const float* X,
                                   float* Y, int R, int C, int GCY,
                                   int GCX, int lo_r, int lo_c, int k_in,
                                   int k_out, void* stream) {
  return dispatch<float>(J, X, Y, R, C, GCY, GCX, lo_r, lo_c, k_in, k_out,
                         stream);
}

extern "C" int lattice_stencil_f64(const double* J, const double* X,
                                   double* Y, int R, int C, int GCY,
                                   int GCX, int lo_r, int lo_c, int k_in,
                                   int k_out, void* stream) {
  return dispatch<double>(J, X, Y, R, C, GCY, GCX, lo_r, lo_c, k_in,
                          k_out, stream);
}
