// Row-slab sharded 2d lattice block-stencil matvec for Hopper (sm_90a):
// one launch for all D shards.
//
// Replaces cracks_tpu/ops/pallas_stencil.py::stencil_matvec_sharded
// (:171), the shard_map wrapper that runs the Pallas TPU kernel _kernel
// (:39) once per y-slab after a one-row ppermute of X each way.  Here
// the D slabs of the leading grid axis that a process holds sit on its
// card, each of rl rows (G0 = 641 padded to 644 on D = 4: rl = 161), and
// a CTA reads its shard's J from the stacked carrier (D, 4k, 4k, rl+1,
// GCXp) that ops/stencil.py::pad_jac_sharded builds once per Newton
// solve, and its X rows, the neighbour shards' boundary rows included,
// straight from the process's X; only the rows of another process (W
// ranks, torch.distributed) come from the two halo-row buffers that
// ops/stencil.py::stencil_matvec_sharded receives from the neighbour
// ranks before the launch.  Y is written in place: no per-shard X, no
// concatenation.  The kernel itself is in lattice_stencil_sharded.cuh.
//
// What bounds it: memory traffic.  The product streams the carrier once
// (the f32 u block of the 640x640-cell lattice on D = 4: 8*8*4*162*640
// values, 106.2 MB with the halo rows; the phase-field block 26.5 MB)
// plus X and Y (3.3 MB each in the u block): at 3.35 TB/s (H100 SXM
// data sheet) at least about 33.5 us for the f32 u block and 8.9 us for
// the phase-field block.  2 flops per J value are far below the card's
// compute rate.
//
// Design: J is read once and never reused, so the kernel is a stream
// and the lever is bytes in flight.  Each CTA (a 60 x TY vertex tile)
// asks TMA for one box per row corner (all K*KL planes of that corner
// for the tile's cells) into a ring of shared-memory stages completed
// through mbarriers (2 stages: many small CTAs on each SM keep more
// bytes in flight than a deeper ring), while its threads read the X
// tile (60+2 by TY+2
// vertices) with plain coalesced loads: X rows are 641 values, not
// 16-byte aligned.  A corner's cells start one column left of the tile,
// and a TMA box must start at a 16-byte aligned column, so each box is
// 64 columns wide and starts 4 columns left of the tile (the carrier's
// rows are padded to 16 bytes for that); TMA's zero fill past the
// carrier's end replaces the bounds check at the far x edge.  TMA
// rather than 16-byte cp.async, which would need the same aligned
// origin: one thread issues a whole box, with no per-thread address
// arithmetic or edge masks, and the mbarrier counts its bytes.  The
// k_out accumulators stay in registers.  The tensor map is encoded on
// the host at each launch (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint: no -lcuda).
//
// The kernel allocates nothing and runs on the caller's stream; each
// entry point returns cudaGetLastError() after the launch (or a negative
// code when the tensor map cannot be made, see the header).

#include "lattice_stencil_sharded.cuh"

namespace {

// Ring stages and tile rows per k, the fastest of the
// variants scripts/tune_sharded_stencil.py timed on an H100 (within 4 %
// of each other): tiles of 60 (f32) or 62 (f64) vertices in 64-cell
// boxes, 2 rows (u block) or 4 (phase-field block), 2 of the 4 corners
// in flight.  Small CTAs, many on each SM, hide the latency better than
// a deeper ring in fewer CTAs.
template <typename T>
int dispatch(const T* JP, const T* X, const T* Xlo, const T* Xhi, T* Y,
             int D, int rl, int row0, int nx, int G0, int GX, int GCXp,
             int k, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k == 2) {
    return sharded::launch<T, 2, 2, 2>(JP, X, Xlo, Xhi, Y, D, rl, row0, nx,
                                       G0, 1, GX, GCXp, 2, stream);
  }
  if (k == 1) {
    return sharded::launch<T, 2, 1, 2>(JP, X, Xlo, Xhi, Y, D, rl, row0, nx,
                                       G0, 1, GX, GCXp, 4, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int lattice_stencil_sharded_f32(const float* JP, const float* X,
                                           const float* Xlo,
                                           const float* Xhi, float* Y,
                                           int D, int rl, int row0, int nx,
                                           int G0, int GX, int GCXp, int k,
                                           void* stream) {
  return dispatch<float>(JP, X, Xlo, Xhi, Y, D, rl, row0, nx, G0, GX, GCXp,
                         k, stream);
}

extern "C" int lattice_stencil_sharded_f64(const double* JP,
                                           const double* X,
                                           const double* Xlo,
                                           const double* Xhi, double* Y,
                                           int D, int rl, int row0, int nx,
                                           int G0, int GX, int GCXp, int k,
                                           void* stream) {
  return dispatch<double>(JP, X, Xlo, Xhi, Y, D, rl, row0, nx, G0, GX, GCXp,
                          k, stream);
}
