// The 2d phase-field block of the lattice stencil product for Hopper
// (sm_90a): k_in = k_out = 1, f32 and f64.  Included by
// lattice_stencil.cu, whose two entry points launch it for every k = 1
// product (the phi block at every GMG level); the u block and the J_pu
// coupling (k = 2) keep the one-thread-per-vertex kernel there.
//
// Replaces, for k = 1, the Pallas TPU kernel
// cracks_tpu/ops/pallas_stencil.py::_kernel (:39).  For every vertex
// (vy, vx) of the (GY, GX) = (GCY + 1, GCX + 1) vertex grid
//
//   Y[vy,vx] = sum_{a,b in 4 corners} J[lo_r + a, lo_c + b, vy-oy_a, vx-ox_a]
//              * X[vy-oy_a+oy_b, vx-ox_a+ox_b]
//
// with (oy, ox) = (a >> 1, a & 1) and cells outside the (GCY, GCX) grid
// contributing nothing; J is the full, contiguous (R, C, GCY, GCX)
// tensor, so the block's 16 planes are J[lo_r + a, lo_c .. lo_c + 3],
// four consecutive planes per row corner a.
//
// What bounds it: memory traffic.  Each J value is read once and used
// once (2 flops): at 640x640 cells the 16 planes are 26.2 MB in f32,
// X and Y 1.6 MB each, 29.5 MB in all, at least 8.8 us at 3.35 TB/s
// (H100 SXM data sheet); 59.0 MB and 17.6 us in f64.  On an NVIDIA H100
// 80GB HBM3 at 700 W, timed from a clean L2 behind a device-side sleep
// (cracks_tpu_torch/kernel_clock.py), a kernel that only reads the 16
// planes takes 14.0-14.3 us (22.3-22.7 us in f64) and an empty launch
// 5.0-5.2 us (scripts/ab_stencil2d.py): the product cannot take less
// than the first, and this kernel and the one-thread-per-vertex kernel
// both land within 1.5 us of it (15.5 us f32, 24.3-24.8 us f64).
//
// Design:
// - A thread owns one item: the V = 16 / sizeof(T) consecutive vertices
//   vx0 = V*q .. vx0 + V - 1 of vertex row vy.  Items are numbered row
//   by row and a CTA takes 64 consecutive ones, so warps run across row
//   ends and only the lattice's last warp has idle lanes (32x8 vertex
//   tiles leave 1 live lane of 32 in each row's last x tile at 641
//   vertices).  One CTA per 64 items, 1,613 CTAs at 640^2 cells in f32.
//   Tried on the card and no faster or slower: CTAs of 128-512 items, a
//   persistent grid-stride loop, bands of whole rows per CTA, 2 or 4 rows
//   interleaved in a warp, 2 or 4 lanes per item (one row corner each,
//   the sums passed on by shuffles), J staged in shared memory by 16-byte
//   cp.async.
// - J in 16-byte units: a thread reads its V cells of each of the 16
//   planes as one 16-byte load (ld.global.nc); a warp's 32 loads cover
//   512 consecutive bytes of a plane row, and all 16 are issued before
//   the first use (16 x 16 bytes in flight per thread).  A corner with
//   ox_a = 1 needs the cells one to the left: V - 1 of them are in the
//   thread's own unit, the first is the last value of the left item's
//   unit, taken from lane - 1 by a warp shuffle; lane 0 reads that one
//   unit itself (aligned, 8 per warp).  No load starts off its 16-byte
//   boundary.  Where GCX is not a multiple of V or J not on 16 bytes
//   (odd grids; 10 cells a side in f32) the same kernel reads units of 2
//   or 1 values (template L), never a unit that crosses a row's end.
// - X: each thread reads its 3 x (V + 2) window through the read-only
//   path; neighbouring items share the lines in L1.  Staging the CTA's
//   X rows in shared memory (cp.async, zero-filled, one barrier) was
//   tried and was no faster in f32 and slower in f64.
// - No host work beyond the launch: addresses come from J's pointer and
//   the strides the entry point gets; no tensor map, no allocation, no
//   synchronisation.
//
// Order of terms: per vertex, corners a ascending, b ascending, acc +=
// J * x from 0, skipping corners whose cell lies outside the grid, as
// the one-thread-per-vertex kernel and lattice_stencil_sharded.cuh do:
// on the same inputs all three give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

// Internal linkage, as in lattice_stencil_sharded.cuh.
namespace {
namespace phi2d {

constexpr int kThreads = 64;       // items (threads) of a CTA

// L values from p (on an L*sizeof(T)-byte boundary) into out[0..L).
template <typename T, int L>
__device__ __forceinline__ void load_unit(const T* p, T* out) {
  if constexpr (L == 1) {
    out[0] = __ldg(p);
  } else if constexpr (L == 2 && sizeof(T) == 4) {
    const float2 u = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = u.x;
    out[1] = u.y;
  } else if constexpr (L == 2) {
    const double2 u = __ldg(reinterpret_cast<const double2*>(p));
    out[0] = u.x;
    out[1] = u.y;
  } else {
    static_assert(L == 4 && sizeof(T) == 4, "16-byte unit");
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = u.x;
    out[1] = u.y;
    out[2] = u.z;
    out[3] = u.w;
  }
}

// Units of L values; nq = ceil(GX / V) items per vertex row.
template <typename T, int THREADS, int L>
__global__ void __launch_bounds__(THREADS)
phi_kernel(const T* __restrict__ J, const T* __restrict__ X,
           T* __restrict__ Y, int C, int GCY, int GCX, int lo_r, int lo_c,
           int nq) {
  constexpr int V = 16 / sizeof(T);           // vertices of an item
  static_assert(V % L == 0, "a unit divides the item");
  const int GY = GCY + 1;
  const int GX = GCX + 1;
  const int64_t plane = static_cast<int64_t>(GCY) * GCX;
  const int64_t corner = static_cast<int64_t>(C) * plane;   // a -> a + 1
  const T* Jb = J + (static_cast<int64_t>(lo_r) * C + lo_c) * plane;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * THREADS + threadIdx.x;
  const int vy = item / nq;
  const int vx0 = (item - vy * nq) * V;
  const bool live = vy < GY;

  // J: j[a][b][0..V) at cells (vy - oy_a, vx0 ..); for a corner with ox_a
  // = 1 the warp's first item (lane 0) also reads the unit left of vx0,
  // for cell vx0 - 1
  T j[4][4][V];
  T left[2][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int cy = vy - (a >> 1);
    const bool row_in = live && cy >= 0 && cy < GCY;
    const T* pa = Jb + a * corner + static_cast<int64_t>(cy) * GCX;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int u = 0; u < V; u += L) {
        if (row_in && vx0 + u < GCX) {
          load_unit<T, L>(pa + b * plane + vx0 + u, &j[a][b][u]);
        } else {
#pragma unroll
          for (int e = 0; e < L; ++e) j[a][b][u + e] = T(0);
        }
      }
      if (a & 1) {
        T unit[L];
        unit[L - 1] = T(0);
        if (lane == 0 && row_in && vx0 > 0) {
          load_unit<T, L>(pa + b * plane + vx0 - L, unit);
        }
        left[a >> 1][b] = unit[L - 1];
      }
    }
  }

  // X window x[r][c] = X[vy - 1 + r, vx0 - 1 + c], zero outside the grid
  T x[3][V + 2];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int row = vy - 1 + r;
#pragma unroll
    for (int c = 0; c < V + 2; ++c) {
      const int col = vx0 - 1 + c;
      x[r][c] = live && row >= 0 && row < GY && col >= 0 && col < GX
                    ? __ldg(X + static_cast<int64_t>(row) * GX + col)
                    : T(0);
    }
  }

  // cell vx0 - 1 of the ox_a = 1 corners: the last value of the unit of
  // the item to the left (lane - 1; lane 0 read its own)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const T v = __shfl_up_sync(0xffffffffu, j[2 * h + 1][b][V - 1], 1);
      if (lane > 0) left[h][b] = v;
    }
  }

  if (!live) return;
  T* out = Y + static_cast<int64_t>(vy) * GX + vx0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vx = vx0 + i;
    T acc = T(0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int cy = vy - (a >> 1);
      const int cx = vx - (a & 1);
      if (cy >= 0 && cy < GCY && cx >= 0 && cx < GCX) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const T jv = (a & 1) ? (i > 0 ? j[a][b][i - 1] : left[a >> 1][b])
                               : j[a][b][i];
          acc += jv * x[1 - (a >> 1) + (b >> 1)][i - (a & 1) + (b & 1) + 1];
        }
      }
    }
    if (vx < GX) out[i] = acc;
  }
}

// One product with units of L values; a CUDA runtime error code (0:
// launched).
template <typename T, int THREADS, int L>
int launch_path(const T* J, const T* X, T* Y, int C, int GCY, int GCX,
                int lo_r, int lo_c, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int nq = (GCX + 1 + V - 1) / V;
  const int64_t items = static_cast<int64_t>(GCY + 1) * nq;
  const int grid = static_cast<int>((items + THREADS - 1) / THREADS);
  phi_kernel<T, THREADS, L><<<grid, THREADS, 0, stream>>>(
      J, X, Y, C, GCY, GCX, lo_r, lo_c, nq);
  return static_cast<int>(cudaGetLastError());
}

// The product as the entry points launch it: 16-byte units where every
// plane row starts on 16 bytes (GCX a multiple of V, J on 16 bytes),
// else 8-byte units (f32, GCX even, J on 8 bytes), else single values.
template <typename T, int THREADS = kThreads>
int launch(const T* J, const T* X, T* Y, int C, int GCY, int GCX, int lo_r,
           int lo_c, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(J);
  if (GCX % V == 0 && addr % 16 == 0) {
    return launch_path<T, THREADS, V>(J, X, Y, C, GCY, GCX, lo_r, lo_c,
                                      stream);
  }
  if constexpr (V > 2) {
    if (GCX % 2 == 0 && addr % (2 * sizeof(T)) == 0) {
      return launch_path<T, THREADS, 2>(J, X, Y, C, GCY, GCX, lo_r, lo_c,
                                        stream);
    }
  }
  return launch_path<T, THREADS, 1>(J, X, Y, C, GCY, GCX, lo_r, lo_c,
                                    stream);
}

}  // namespace phi2d
}  // namespace
