// The row-slab sharded lattice block-stencil product for Hopper
// (sm_90a): one launch over all D shards, in 2d (DIM = 2) and 3d
// (DIM = 3).  Included by lattice_stencil_sharded.cu (2d) and
// lattice_stencil3d_sharded.cu (3d), whose notes say what each replaces
// and what bounds it.
//
// Inputs:
//   JP  the stacked per-shard J carrier (D, KL, KL, rl+1, [GCY,] GCXp),
//       contiguous, KL = 2**DIM * K, GCXp = GCX rounded up to a
//       multiple of 4 values (16-byte rows for TMA).  Slab s holds the
//       cell rows (2d) / planes (3d) s*rl - 1 .. (s+1)*rl - 1 of the
//       square J block at local rows 0..rl; rows outside the lattice
//       and the pad columns are zero.
//   X   this process's rows of the lattice, (K, nx, [GY,] GX),
//       contiguous: the lattice rows row0 .. row0 + nx - 1 (one process:
//       row0 = 0, nx = G0, the whole lattice);
//   Xlo, Xhi  the halo rows (K, 1, [GY,] GX) of the rows row0 - 1 and
//       row0 + nx, received from the neighbour processes, or null at
//       the lattice's ends, where the kernel reads zeros;
//   Y   the shape of X, written for every row of X.
// G0 is the lattice's end as far as this process sees: row0 + nx where
// Xhi is null, row0 + nx + 1 otherwise.
//
// A CTA owns a tile of output vertices inside one shard s: TY rows of
// TXV vertices (2d), or one plane of TY rows of TXV vertices (3d); TXV
// is the whole row where the box can hold one (3d: GX = 81), else a
// part.  For each of the 2**DIM row corners a, the J values of corner a
// for the whole tile are the K*KL consecutive carrier planes
// a*K*KL .. (a+1)*K*KL - 1 at cells tile - o_a: one TMA box.  TMA
// computes the addresses, fills cells past the carrier's end with zeros
// and signals an mbarrier; a ring of STAGES boxes in dynamic shared
// memory keeps up to STAGES corners in flight.  On the card a box whose
// x origin is not 16-byte aligned, or is negative, faults (illegal
// instruction), so every box starts at the aligned cell max(x0 - A, 0),
// A = 16 bytes of values, and is W >= TXV + A cells wide: it holds the
// cells x0 - 1 .. x0 + TXV - 1 of both x corners (a whole-row box
// starts at 0 and spans the carrier's row); the A cells a part-row box
// shares with the tile to its left are read by both.  X's tile with
// its one-vertex ring is read once per CTA into shared memory: a
// neighbour shard's boundary row from X where the shard is this
// process's, from Xlo / Xhi where it is another process's, and rows
// outside [0, G0) are zero.  That load is the non-circular ppermute of
// the JAX wrapper, so no exchange launches inside a process; across
// processes the rows arrive in the two halo buffers.
//
// Order of terms: per output vertex the sum runs over a, b, e, d with
// the same skip of cells outside the lattice and the same acc += J * x
// form as lattice_stencil{,3d}.cu, on the same J and X values, so the
// sharded product equals the unsharded kernel bit for bit, and a
// process's rows equal the same rows of the one-process product.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

// Internal linkage: each library that includes this header keeps its own
// instances (and their statics, such as the shared-memory limit set on
// a kernel), even when another loaded library instantiates the same
// templates.
namespace {
namespace sharded {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// Corner a's offsets along the sharded axis (y in 2d, z in 3d), the 3d
// y axis and x: the bit order of lattice_stencil{,3d}.cu.
template <int DIM>
__host__ __device__ constexpr int off0(int a) {
  return DIM == 2 ? (a >> 1) & 1 : (a >> 2) & 1;
}
template <int DIM>
__host__ __device__ constexpr int off1(int a) {
  return DIM == 2 ? 0 : (a >> 1) & 1;
}
__host__ __device__ constexpr int offx(int a) { return a & 1; }

template <typename T, int DIM, int K>
struct Block {
  static constexpr int NC = 1 << DIM;             // corners of a cell
  static constexpr int KL = NC * K;               // block rows = columns
  static constexpr int PLANES = K * KL;           // J planes of a corner
  static constexpr int A = 16 / sizeof(T);        // 16 bytes of values
  static constexpr int XZ = DIM == 3 ? 3 : 1;     // X tile planes
  static_assert(PLANES <= 256, "TMA box limit");
};

// The tile and box geometry of one launch: TXV vertices by TY rows per
// tile, boxes W cells wide, each ring stage `stage` values apart (a
// multiple of 128 bytes) and the X tile `xt` values per component.
struct Geometry {
  int txv, ty, w, threads, stage, xt;
  size_t smem;
};

template <typename T, int DIM, int K, int STAGES>
__global__ void __launch_bounds__(256)
sharded_kernel(const __grid_constant__ CUtensorMap jmap,
               const T* __restrict__ X, const T* __restrict__ Xlo,
               const T* __restrict__ Xhi, T* __restrict__ Y, int G0,
               int GY, int GX, int rl, int tiles0, int row0, int nx,
               Geometry g) {
  using B = Block<T, DIM, K>;
  const int s = blockIdx.y / tiles0;                 // this process's shard
  const int l0 = (blockIdx.y % tiles0) * (DIM == 2 ? g.ty : 1);
  if (s * rl + l0 >= nx) return;          // only pad rows: nothing to do
  const int v0 = row0 + s * rl + l0;      // the tile's first lattice row
  const int vy0 = DIM == 3 ? blockIdx.z * g.ty : 0;
  const int vx0 = blockIdx.x * g.txv;
  const int tx = threadIdx.x % g.txv;
  const int ty = threadIdx.x / g.txv;     // >= g.ty: an idle thread

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  T* ring = reinterpret_cast<T*>(base + 128);
  T* xs = ring + STAGES * g.stage;

  // Corner a's box into stage st: planes a*PLANES.., cells from
  // (bx, tile row - o_a).  In 3d the first tile along y starts its box
  // at row 0, one row below tile - o_a for a corner with o_y = 1: that
  // shift moves the thread's row in the box, and the row it drops, -1,
  // is outside the lattice and skipped.
  const CUtensorMap* map = &jmap;
  const int bx = max(vx0 - B::A, 0);
  auto shift_y = [=](int a) {
    const int y = vy0 - off1<DIM>(a);
    return DIM == 3 ? max(y, 0) - y : 0;
  };
  const uint32_t box_bytes = g.w * g.ty * B::PLANES * sizeof(T);
  auto issue = [=](int a, int st) {
    mbar_expect_tx(&bar[st], box_bytes);
    if constexpr (DIM == 2) {
      tma_load4(ring + st * g.stage, map, &bar[st], bx,
                l0 + 1 - off0<DIM>(a), a * B::PLANES, s);
    } else {
      tma_load5(ring + st * g.stage, map, &bar[st], bx,
                vy0 - off1<DIM>(a) + shift_y(a), l0 + 1 - off0<DIM>(a),
                a * B::PLANES, s);
    }
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(&bar[st], 1);
    fence_barrier_init();
    for (int a = 0; a < STAGES; ++a) issue(a, a);
  }

  // X's tile and its one-vertex ring, zero outside the lattice
  const int xw = g.txv + 2;
  const int64_t rowsize = static_cast<int64_t>(GY) * GX;
  const int64_t vplane = nx * rowsize;
  for (int i = threadIdx.x; i < K * g.xt; i += blockDim.x) {
    const int e = i / g.xt;
    const int r = i % g.xt;
    const int xx = vx0 - 1 + r % xw;
    const int rest = r / xw;
    const int yy = DIM == 3 ? vy0 - 1 + rest % (g.ty + 2) : 0;
    const int zz = v0 - 1 + (DIM == 3 ? rest / (g.ty + 2) : rest);
    const int zl = zz - row0;             // the row in this process's X
    T v = T(0);
    if (zz >= 0 && zz < G0 && yy >= 0 && yy < GY && xx >= 0 && xx < GX) {
      const int64_t at = yy * GX + xx;
      if (zl < 0) {
        if (Xlo != nullptr) v = Xlo[e * rowsize + at];
      } else if (zl >= nx) {
        if (Xhi != nullptr) v = Xhi[e * rowsize + at];
      } else {
        v = X[e * vplane + zl * rowsize + at];
      }
    }
    xs[i] = v;
  }
  __syncthreads();

  // this thread's output vertex (vz, vy, vx), vy = 0 in 2d
  const int vz = v0 + (DIM == 2 ? ty : 0);
  const int vy = DIM == 3 ? vy0 + ty : 0;
  const int vx = vx0 + tx;
  const bool valid = ty < g.ty && vx < GX && vy < GY &&
                     vz - row0 < nx && (DIM == 3 || l0 + ty < rl);
  const int pstride = g.w * g.ty;         // a box's plane

  T acc[K];
#pragma unroll
  for (int d = 0; d < K; ++d) acc[d] = T(0);

#pragma unroll
  for (int a = 0; a < B::NC; ++a) {
    const int st = a % STAGES;
    mbar_wait(&bar[st], (a / STAGES) & 1);
    const int cz = vz - off0<DIM>(a);
    const int cy = vy - off1<DIM>(a);
    const int cx = vx - offx(a);
    if (valid && cz >= 0 && cz < G0 - 1 && cx >= 0 && cx < GX - 1 &&
        (DIM == 2 || (cy >= 0 && cy < GY - 1))) {
      const T* J = ring + st * g.stage + (ty - shift_y(a)) * g.w +
                   (cx - bx);
#pragma unroll
      for (int b = 0; b < B::NC; ++b) {
        // the X tile's row (2d) or plane and row (3d) of v - o_a + o_b
        const int xrow =
            DIM == 2 ? ty + 1 - off0<DIM>(a) + off0<DIM>(b)
                     : (1 - off0<DIM>(a) + off0<DIM>(b)) * (g.ty + 2) +
                           ty + 1 - off1<DIM>(a) + off1<DIM>(b);
        const int xi = xrow * xw + tx + 1 - offx(a) + offx(b);
#pragma unroll
        for (int e = 0; e < K; ++e) {
          const T xv = xs[e * g.xt + xi];
#pragma unroll
          for (int d = 0; d < K; ++d) {
            acc[d] += J[(d * B::KL + b * K + e) * pstride] * xv;
          }
        }
      }
    }
    if (a + STAGES < B::NC) {
      __syncthreads();                  // every thread is done with st
      if (threadIdx.x == 0) issue(a + STAGES, st);
    }
  }
  if (valid) {
    const int64_t out = (vz - row0) * rowsize + vy * GX + vx;
#pragma unroll
    for (int d = 0; d < K; ++d) Y[d * vplane + out] = acc[d];
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so
// the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The geometry of a launch with rows of GX vertices: in 3d the whole
// row when its box fits TMA's 256-cell limit and the block 256 threads,
// else (2d: GX = 641) tiles of 64 - A vertices with 64-cell boxes; TY
// rows per tile, fewer where the block would pass 256 threads.
constexpr int kPartBox = 64;

template <typename T, int DIM, int K, int STAGES>
Geometry geometry(int GX, int GCXp, int ty) {
  using B = Block<T, DIM, K>;
  Geometry g;
  const bool whole = DIM == 3 && GCXp <= 256 && GX <= 256;
  g.txv = whole ? GX : kPartBox - B::A;
  g.w = whole ? GCXp : kPartBox;
  g.ty = ty;
  while (g.ty > 1 && g.txv * g.ty > 256) --g.ty;
  g.threads = (g.txv * g.ty + 31) / 32 * 32;
  const int box = g.w * g.ty * B::PLANES;
  const int per128 = 128 / sizeof(T);
  g.stage = (box + per128 - 1) / per128 * per128;
  g.xt = B::XZ * (g.ty + 2) * (g.txv + 2);
  // 128 bytes of alignment slack, 128 for the barriers, the ring, X
  g.smem = 256 + (static_cast<size_t>(STAGES) * g.stage +
                  static_cast<size_t>(K) * g.xt) * sizeof(T);
  return g;
}

// Error codes: a CUDA runtime error, or -1 when the driver has no
// cuTensorMapEncodeTiled, or -(1000 + CUresult) when encoding fails.
// D is the number of this process's shards, whose rows of the lattice
// start at row0 (see the inputs above).
template <typename T, int DIM, int K, int STAGES>
int launch(const T* JP, const T* X, const T* Xlo, const T* Xhi, T* Y,
           int D, int rl, int row0, int nx, int G0, int GY, int GX,
           int GCXp, int ty, cudaStream_t stream) {
  using B = Block<T, DIM, K>;
  static_assert(STAGES >= 1 && STAGES <= B::NC && STAGES <= 16, "stages");
  const Geometry g = geometry<T, DIM, K, STAGES>(GX, GCXp, ty);
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return -1;
  // carrier dims, innermost first: x cells, [y cells,] local rows,
  // planes (row * KL + col), shards
  constexpr int R = DIM + 2;
  cuuint64_t dims[R];
  cuuint32_t box[R];
  dims[0] = GCXp;
  box[0] = g.w;
  if (DIM == 3) {
    dims[1] = GY - 1;
    box[1] = g.ty;
  }
  dims[DIM - 1] = rl + 1;
  box[DIM - 1] = DIM == 2 ? g.ty : 1;
  dims[DIM] = static_cast<cuuint64_t>(B::KL) * B::KL;
  box[DIM] = B::PLANES;
  dims[DIM + 1] = D;
  box[DIM + 1] = 1;
  cuuint64_t strides[R - 1];
  cuuint32_t elem[R];
  cuuint64_t stride = sizeof(T);
  for (int i = 0; i < R; ++i) {
    elem[i] = 1;
    stride *= dims[i];
    if (i < R - 1) strides[i] = stride;
  }
  CUtensorMap map;
  CUresult res = encode(
      &map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
      R, const_cast<T*>(JP), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -(1000 + static_cast<int>(res));

  auto kernel = sharded_kernel<T, DIM, K, STAGES>;
  static size_t smem_set = 48 * 1024;     // what the kernel may use
  if (g.smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = g.smem;
  }
  const int tiles0 = DIM == 2 ? (rl + g.ty - 1) / g.ty : rl;
  const dim3 grid((GX + g.txv - 1) / g.txv, D * tiles0,
                  DIM == 3 ? (GY + g.ty - 1) / g.ty : 1);
  kernel<<<grid, g.threads, g.smem, stream>>>(map, X, Xlo, Xhi, Y, G0, GY,
                                               GX, rl, tiles0, row0, nx, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sharded
}  // namespace
