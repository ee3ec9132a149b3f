// Row-slab sharded 3d lattice block-stencil matvec for Hopper (sm_90a):
// one launch for all D shards.
//
// Replaces cracks_tpu/ops/pallas_stencil.py::stencil_matvec3d_sharded
// (:368), the shard_map wrapper that runs the Pallas TPU kernel
// _kernel3d (:232) once per z-slab after a one-plane ppermute of X each
// way.  Here the D slabs of the leading grid axis that a process holds
// sit on its card, each of rl planes (G0 = 81 padded to 84 on D = 4:
// rl = 21), and a CTA reads its shard's J from the stacked carrier (D,
// 8k, 8k, rl+1, GCY, GCXp) that ops/stencil.py::pad_jac_sharded builds
// once per Newton solve, and its X planes, the neighbour shards'
// boundary planes included, straight from the process's X; only the
// planes of another process (W ranks) come from the two halo-plane
// buffers that ops/stencil.py::stencil_matvec_sharded receives from the
// neighbour ranks before the launch.  Y is written in place: no
// per-shard X, no concatenation.  The kernel itself is in
// lattice_stencil_sharded.cuh.
//
// What bounds it: memory traffic.  The product streams the carrier once
// (the f32 u block of the 80^3-cell lattice on D = 4: 24*24*4*22*80*80
// values, 1.30 GB with the halo planes; the phase-field block 144 MB)
// plus X and Y (6.4 MB each in the u block): at 3.35 TB/s (H100 SXM
// data sheet) at least about 374 us for the f32 u block and 42 us for
// the phase-field block.  2 flops per J value are far below the card's
// compute rate.
//
// Design: J is read once and never reused, so the kernel is a stream
// and the lever is bytes in flight and long runs.  Each CTA (a whole
// row of 81 vertices, or TY rows of it, in one plane) asks TMA for one
// box per row corner (all K*KL planes of that corner for the tile's
// cells: 72 planes of 80 x TY cells in the u block, each plane's part
// one contiguous run of TY*320 bytes) into a ring of shared-memory
// stages completed through mbarriers; the ring holds 2 of the u block's
// 8 corners (a stage is refilled as soon as every thread is done with
// it), so 4 CTAs fit on each SM.  The X tile (3 planes of TY+2 rows of
// 83 vertices) is read with plain coalesced loads: X rows are 81
// values, not 16-byte aligned.  A whole-row box starts at cell 0, which
// a TMA box needs (a 16-byte aligned, non-negative x origin; wider rows
// take part-row tiles as in 2d), and holds both x corners' cells; TMA's
// zero fill past the carrier's end replaces the bounds checks at the far
// y edge.  TMA rather than 16-byte cp.async, which would need the same
// aligned origin: one thread issues a whole box, with no per-thread
// address arithmetic or edge masks, and the mbarrier counts its bytes.
// The k_out accumulators stay in registers; offsets into X and Y are
// 64-bit (the f32 u carrier holds 3.2e8 values; TMA addresses J
// itself).  The tensor map is encoded on the host at each launch
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: no -lcuda).
//
// The kernel allocates nothing and runs on the caller's stream; each
// entry point returns cudaGetLastError() after the launch (or a negative
// code when the tensor map cannot be made, see the header).

#include "lattice_stencil_sharded.cuh"

namespace {

// Ring stages and tile rows per k, the fastest of the variants
// scripts/tune_sharded_stencil.py timed on an H100: whole-row boxes; in
// the u block one row per tile and 2 of its 8 corner boxes (23 KB each
// in f32) in flight, 1 in f64; in the phase-field block 2 rows and 4
// boxes.  Small CTAs, 4 or more on each SM, hide the latency better than
// a deeper ring: 4 stages of the u block took 656 us, 2 took 460 us.
template <typename T>
int dispatch(const T* JP, const T* X, const T* Xlo, const T* Xhi, T* Y,
             int D, int rl, int row0, int nx, int G0, int GY, int GX,
             int GCXp, int k, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  constexpr bool f32 = sizeof(T) == 4;
  if (k == 3) {
    return sharded::launch<T, 3, 3, f32 ? 2 : 1>(
        JP, X, Xlo, Xhi, Y, D, rl, row0, nx, G0, GY, GX, GCXp, 1, stream);
  }
  if (k == 1) {
    return sharded::launch<T, 3, 1, 4>(JP, X, Xlo, Xhi, Y, D, rl, row0, nx,
                                       G0, GY, GX, GCXp, 2, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int lattice_stencil3d_sharded_f32(
    const float* JP, const float* X, const float* Xlo, const float* Xhi,
    float* Y, int D, int rl, int row0, int nx, int G0, int GY, int GX,
    int GCXp, int k, void* stream) {
  return dispatch<float>(JP, X, Xlo, Xhi, Y, D, rl, row0, nx, G0, GY, GX,
                         GCXp, k, stream);
}

extern "C" int lattice_stencil3d_sharded_f64(
    const double* JP, const double* X, const double* Xlo, const double* Xhi,
    double* Y, int D, int rl, int row0, int nx, int G0, int GY, int GX,
    int GCXp, int k, void* stream) {
  return dispatch<double>(JP, X, Xlo, Xhi, Y, D, rl, row0, nx, G0, GY, GX,
                          GCXp, k, stream);
}
