// Native forest core: canonical lattice-point keys.
//
// The port's copy of the JAX package's native forest core, the
// native-runtime analogue of p4est (a C library in the reference stack,
// SURVEY.md section 2b: deal.II's parallel::distributed::Triangulation
// delegates octree administration to p4est, cracks.cc:1083).  The hot
// mesh-administration primitive of cracks_tpu_torch/mesh.py is
// Forest.canonical_keys — the canonical 64-bit key of a lattice point
// that establishes vertex identity across neighbouring root cells (and
// across the topological slit) — called on O(cells * 3^dim) points by
// extract() and every balance_flags() pass.
//
// Key layout (MUST match cracks_tpu_torch/mesh.py exactly; all-integer
// math, bit-for-bit equality is tested in tests/test_torch_host.py):
//   kind = interior(0) | corner(1) | edge(2) | face(3), stored in the
//   top bits (kind << 62); payloads as in mesh.py canonical_keys.
//
// Built as a plain shared library with a C ABI and loaded via ctypes
// (no pybind11 needed); cracks_tpu_torch/native/__init__.py compiles
// it on first use into cracks_tpu_torch/build/ and falls back to the
// numpy implementation when no toolchain is available.

#include <cstdint>

namespace {

using i64 = long long;

// first index d in [0, dim) with !on[d]  (numpy argmin over bools)
inline int first_free(const bool* on, int dim) {
  for (int d = 0; d < dim; ++d)
    if (!on[d]) return d;
  return 0;
}

// first index d in [0, dim) with on[d]  (numpy argmax over bools)
inline int first_pinned(const bool* on, int dim) {
  for (int d = 0; d < dim; ++d)
    if (on[d]) return d;
  return 0;
}

}  // namespace

extern "C" {

// root: (n,), coords: (n, dim) row-major, both int64.
// cells: (n_roots, 1<<dim) coarse cell->vertex ids.
// face_uid: (n_roots, 6) and root_face_vids: (n_roots, 6, 4) — 3d only
// (pass nullptr in 2d).
// K = MAX_COARSE_VERTS (the signature base for face canonicalization).
// Writes keys to out (n,).
void canonical_keys(int dim, i64 S, int L, i64 K, i64 n,
                    const i64* root, const i64* coords, const i64* cells,
                    const i64* face_uid, const i64* root_face_vids,
                    i64* out) {
  const int nvc = 1 << dim;
  // kinds 2 and 3 shift into the sign bit; numpy int64 wraps, so use
  // unsigned arithmetic and reinterpret (two's complement) to match
  const i64 KIND_CORNER = (i64)(1ULL << 62);
  const i64 KIND_EDGE = (i64)(2ULL << 62);
  const i64 KIND_FACE = (i64)(3ULL << 62);

  for (i64 i = 0; i < n; ++i) {
    const i64 r = root[i];
    const i64* c = coords + i * dim;
    bool lo[3], hi[3], on[3];
    int nb = 0;
    for (int d = 0; d < dim; ++d) {
      lo[d] = (c[d] == 0);
      hi[d] = (c[d] == S);
      on[d] = lo[d] | hi[d];
      nb += on[d];
    }

    if (nb == 0) {  // interior of the root
      i64 k = r;
      for (int d = 0; d < dim; ++d) k = (k << (L + 1)) | c[d];
      out[i] = k;  // KIND_INTERIOR == 0
      continue;
    }

    if (nb == dim) {  // coarse corner
      i64 idx = 0;
      for (int d = 0; d < dim; ++d) idx |= i64(hi[d]) << d;
      out[i] = KIND_CORNER | cells[r * nvc + idx];
      continue;
    }

    if (nb == dim - 1) {  // on a coarse edge (2d side / 3d edge)
      const int free_d = first_free(on, dim);
      i64 base = 0;
      for (int d = 0; d < dim; ++d)
        if (d != free_d) base |= i64(hi[d]) << d;
      i64 a = cells[r * nvc + base];
      i64 b = cells[r * nvc + (base | (1LL << free_d))];
      i64 t = c[free_d];
      if (a > b) {
        const i64 tmp = a; a = b; b = tmp;
        t = S - t;
      }
      i64 k = (a << 14) | b;
      k = (k << (L + 1)) | t;
      out[i] = KIND_EDGE | k;
      continue;
    }

    // 3d only: interior of a coarse face (nb == 1, dim == 3)
    {
      const int d_pin = first_pinned(on, dim);
      const int side = 2 * d_pin + (hi[d_pin] ? 1 : 0);
      const i64* C = root_face_vids + (r * 6 + side) * 4;  // c00 c10 c01 c11
      const i64 uid = face_uid[r * 6 + side];
      const int ud = (d_pin == 0) ? 1 : 0;
      const int vd = (d_pin == 2) ? 1 : 2;
      const i64 u = c[ud], v = c[vd];
      // canonicalize (u, v) over the 8 symmetries of the square by the
      // minimal corner-id signature; loop order and the strict '<'
      // replicate mesh.py's np.where(better) update exactly
      i64 best_sig = -1, best_u = 0, best_v = 0;
      for (int swapuv = 0; swapuv < 2; ++swapuv)
        for (int fu = 0; fu < 2; ++fu)
          for (int fv = 0; fv < 2; ++fv) {
            // corner id at transformed (i, j)
            auto cid = [&](int ii, int jj) -> i64 {
              int a = swapuv ? jj : ii;
              int b = swapuv ? ii : jj;
              if (fu) a = 1 - a;
              if (fv) b = 1 - b;
              return C[a + 2 * b];
            };
            const i64 sig = (cid(0, 0) * K + cid(1, 0)) * K + cid(0, 1);
            i64 uu = swapuv ? v : u;
            i64 vv = swapuv ? u : v;
            if (fu) uu = S - uu;
            if (fv) vv = S - vv;
            if (best_sig < 0 || sig < best_sig) {
              best_sig = sig; best_u = uu; best_v = vv;
            }
          }
      i64 k = uid;
      k = (k << (L + 1)) | best_u;
      k = (k << (L + 1)) | best_v;
      out[i] = KIND_FACE | k;
    }
  }
}

}  // extern "C"
