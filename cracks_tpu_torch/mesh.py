"""Adaptive quad-/octree forest over an unstructured coarse root mesh.

The port's copy of ``cracks_tpu/mesh.py``: the replacement for p4est +
deal.II's distributed triangulation/DoFHandler (reference
cracks.cc:1083, 1579-1680,
3895-4163): a forest of structured quadtrees/octrees, one per coarse
("root") cell, with

 * vectorized (numpy) mesh administration on the host,
 * 2:1 "full" balance (level difference <= 1 between any two cells whose
   closures touch, like p4est CONNECT_FULL used by deal.II),
 * hanging-node constraints as gather/scatter index arrays,
 * solution transfer across refinement by Q1 injection/interpolation
   (replacement for parallel::distributed::SolutionTransfer,
   cracks.cc:4137-4159),

and produces flat device-ready arrays: `cell2vert` gather maps, vertex
coordinates, boundary vertex sets and boundary faces.

Vertex identity is established through *coarse connectivity*, never
through coordinates, so topological slits (meshes/unit_slit.inp has two
distinct vertices at (1, 0.5) forming a crack slit) are preserved.

Every lattice point is identified by a canonical 64-bit key:
  interior points  -> (root, lattice coords)
  points on a root face/edge/corner -> canonicalized via the coarse
  vertex ids of that entity, so the key is identical from both sides.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .meshio import CoarseMesh, face_vertices

# Maximum refinement depth such that all keys pack into int64.
MAX_LEVEL = {2: 23, 3: 15}
MAX_ROOTS = 1 << 14
MAX_COARSE_VERTS = 1 << 14

_KIND_INTERIOR = 0
_KIND_CORNER = 1
_KIND_EDGE = 2
_KIND_FACE = 3

# 3D reference-cell edges: (lo corner, hi corner) local indices, for each
# of the 12 edges; corners are lexicographic (bit d set <=> coord d == 1).
_EDGES_3D = []
for _d in range(3):
    for _c in range(4):
        _others = [dd for dd in range(3) if dd != _d]
        _lo = 0
        _lo |= ((_c >> 0) & 1) << _others[0]
        _lo |= ((_c >> 1) & 1) << _others[1]
        _hi = _lo | (1 << _d)
        _EDGES_3D.append((_lo, _hi))

_EDGES_2D = [(0, 1), (2, 3), (0, 2), (1, 3)]


def _morton(anchor: np.ndarray, dim: int) -> np.ndarray:
    """Interleave-free deterministic cell ordering key (y-major)."""
    # Plain lexicographic (z, y, x) is sufficient for determinism.
    key = anchor[:, dim - 1].astype(np.int64)
    for d in range(dim - 2, -1, -1):
        key = (key << 24) | anchor[:, d].astype(np.int64)
    return key


@dataclass
class MeshData:
    """Flat arrays describing the current active mesh (device-ready)."""

    dim: int
    cell2vert: np.ndarray        # (n_cells, 2**dim) int32, lexicographic
    vert_coords: np.ndarray      # (n_verts, dim) float64
    cell_coords: np.ndarray      # (n_cells, 2**dim, dim) float64
    cell_level: np.ndarray       # (n_cells,) int32
    cell_root: np.ndarray        # (n_cells,) int64
    diameters: np.ndarray        # (n_cells,) float64 (max vertex distance)
    vertex_keys: np.ndarray      # (n_verts,) int64, sorted (canonical keys)
    # hanging-node constraints: child vertex = sum(weights * masters)
    hang_child: np.ndarray       # (n_h,) int32
    hang_masters: np.ndarray     # (n_h, 4) int32 (padded by repeating)
    hang_weights: np.ndarray     # (n_h, 4) float64
    # boundary faces: per face the owning cell, local face index, bid
    bface_cell: np.ndarray       # (n_bf,) int32
    bface_face: np.ndarray       # (n_bf,) int32
    bface_id: np.ndarray         # (n_bf,) int32
    boundary_vertices: dict = field(default_factory=dict)  # bid -> int32 array

    @property
    def n_cells(self) -> int:
        return len(self.cell2vert)

    @property
    def n_vertices(self) -> int:
        return len(self.vert_coords)

    @property
    def n_dofs(self) -> int:
        return self.n_vertices * (self.dim + 1)

    @property
    def min_cell_diameter(self) -> float:
        return float(self.diameters.min())

    def hanging_mask(self) -> np.ndarray:
        m = np.zeros(self.n_vertices, dtype=bool)
        m[self.hang_child] = True
        return m


class Forest:
    """The adaptive forest: active cells as (root, level, anchor) triples."""

    def __init__(self, coarse: CoarseMesh):
        if coarse.n_cells >= MAX_ROOTS:
            raise ValueError("too many coarse cells")
        if coarse.n_vertices >= MAX_COARSE_VERTS:
            raise ValueError("too many coarse vertices")
        self.coarse = coarse
        self.dim = coarse.dim
        self.max_level = MAX_LEVEL[self.dim]
        self.S = 1 << self.max_level
        n = coarse.n_cells
        self.root = np.arange(n, dtype=np.int64)
        self.level = np.zeros(n, dtype=np.int32)
        self.anchor = np.zeros((n, self.dim), dtype=np.int64)
        self._build_coarse_tables()

    # ------------------------------------------------------------------
    # coarse connectivity tables
    # ------------------------------------------------------------------
    def _build_coarse_tables(self):
        dim = self.dim
        cells = self.coarse.cells  # (n_roots, 2**dim)
        faces = face_vertices(dim)
        # face corner coarse-vertex ids per (root, side):
        self.root_face_vids = np.stack(
            [cells[:, list(f)] for f in faces], axis=1
        )  # (n_roots, 2*dim, 2**(dim-1))

        if dim == 3:
            self.root_edge_vids = np.stack(
                [cells[:, [lo, hi]] for lo, hi in _EDGES_3D], axis=1
            )  # (n_roots, 12, 2)
            # canonical face uid: same 4 corner ids (as a sorted tuple)
            # => same uid, regardless of orientation.
            sorted_faces = np.sort(
                self.root_face_vids.reshape(-1, 4), axis=1)
            uniq, inv = np.unique(sorted_faces, axis=0, return_inverse=True)
            self.face_uid = inv.reshape(len(cells), 6)   # (n_roots, 6)
            face_counts = np.bincount(inv, minlength=len(uniq))
            self.face_shared = face_counts[self.face_uid] > 1  # (n_roots, 6)
        else:
            # 2D: faces are edges; shared iff the sorted vertex pair occurs twice
            sorted_faces = np.sort(self.root_face_vids.reshape(-1, 2), axis=1)
            uniq, inv = np.unique(sorted_faces, axis=0, return_inverse=True)
            face_counts = np.bincount(inv, minlength=len(uniq))
            self.face_shared = (face_counts[inv] > 1).reshape(len(cells), 4)

        # boundary id per (root, side): from the coarse mesh's boundary map
        # (default 0, as in deal.II).
        nsides = 2 * dim
        self.face_bid = np.zeros((len(cells), nsides), dtype=np.int32)
        for r in range(len(cells)):
            for s in range(nsides):
                key = tuple(sorted(self.root_face_vids[r, s].tolist()))
                self.face_bid[r, s] = self.coarse.boundary_ids.get(key, 0)

    # ------------------------------------------------------------------
    # canonical keys
    # ------------------------------------------------------------------
    def canonical_keys(self, root: np.ndarray, coords: np.ndarray) -> np.ndarray:
        """Canonical int64 key for lattice points (root frame -> global).

        root: (n,) int64; coords: (n, dim) int64 in [0, S].

        Dispatches to the native C++ core (cracks_tpu_torch/native, the
        p4est-analogue runtime component) when available; the numpy body
        below is the bit-identical fallback.
        """
        dim, S, L = self.dim, self.S, self.max_level
        from . import native
        k_native = native.canonical_keys(
            dim, S, L, MAX_COARSE_VERTS, root, coords, self.coarse.cells,
            getattr(self, "face_uid", None) if dim == 3 else None,
            self.root_face_vids if dim == 3 else None)
        if k_native is not None:
            return k_native
        n = len(root)
        lo = coords == 0
        hi = coords == S
        on = lo | hi
        nb = on.sum(axis=1)
        keys = np.zeros(n, dtype=np.int64)

        cells = self.coarse.cells

        # interior
        m = nb == 0
        if m.any():
            k = root[m]
            for d in range(dim):
                k = (k << (L + 1)) | coords[m, d]
            keys[m] = (np.int64(_KIND_INTERIOR) << 62) | k

        # corner
        m = nb == dim
        if m.any():
            idx = np.zeros(m.sum(), dtype=np.int64)
            for d in range(dim):
                idx |= hi[m, d].astype(np.int64) << d
            vid = cells[root[m], idx]
            keys[m] = (np.int64(_KIND_CORNER) << 62) | vid

        # on a coarse edge (2D: nb==1 means on a side=edge; 3D: nb==2)
        m = nb == (dim - 1)
        if m.any():
            rm = root[m]
            com = coords[m]
            lom, him = lo[m], hi[m]
            onm = lom | him
            # free dimension
            free = np.argmin(onm, axis=1)
            # local corner index of the edge's low end
            base = np.zeros(m.sum(), dtype=np.int64)
            for d in range(dim):
                base |= (him[:, d] & (np.arange(dim)[d] != free)).astype(np.int64) << d
            a = cells[rm, base]                      # id at free-coord 0
            b = cells[rm, base | (np.int64(1) << free)]  # id at free-coord S
            t = com[np.arange(m.sum()), free]
            swap = a > b
            amin = np.where(swap, b, a)
            bmax = np.where(swap, a, b)
            tc = np.where(swap, S - t, t)
            k = (amin << 14) | bmax
            k = (k << (L + 1)) | tc
            keys[m] = (np.int64(_KIND_EDGE) << 62) | k

        # on a coarse face interior (3D only)
        if dim == 3:
            m = nb == 1
            if m.any():
                rm = root[m]
                com = coords[m]
                him = hi[m]
                onm = on[m]
                d_pin = np.argmax(onm, axis=1)
                side = 2 * d_pin + him[np.arange(m.sum()), d_pin]
                corners = self.root_face_vids[rm, side]  # (k, 4) lex in (u,v)
                uid = self.face_uid[rm, side]
                # free dims u < v
                d_all = np.arange(3)
                freedims = np.stack(
                    [np.where(d_pin == 0, 1, 0), np.where(d_pin == 2, 1, 2)], axis=1
                )
                u = com[np.arange(m.sum()), freedims[:, 0]]
                v = com[np.arange(m.sum()), freedims[:, 1]]
                del d_all
                # canonicalize over the 8 symmetries of the square
                K = np.int64(MAX_COARSE_VERTS)
                best_sig = None
                best_u = None
                best_v = None
                C = corners  # C[:,0]=c00, C[:,1]=c10, C[:,2]=c01, C[:,3]=c11
                for swapuv in (False, True):
                    for fu in (False, True):
                        for fv in (False, True):
                            # index of corner at (i, j) after transform
                            def cid(i, j):
                                ii, jj = (j, i) if swapuv else (i, j)
                                ii = 1 - ii if fu else ii
                                jj = 1 - jj if fv else jj
                                return C[:, ii + 2 * jj]
                            sig = (cid(0, 0) * K + cid(1, 0)) * K + cid(0, 1)
                            uu, vv = (v, u) if swapuv else (u, v)
                            uu = S - uu if fu else uu
                            vv = S - vv if fv else vv
                            if best_sig is None:
                                best_sig, best_u, best_v = sig, uu, vv
                            else:
                                better = sig < best_sig
                                best_sig = np.where(better, sig, best_sig)
                                best_u = np.where(better, uu, best_u)
                                best_v = np.where(better, vv, best_v)
                k = uid.astype(np.int64)
                k = (k << (L + 1)) | best_u
                k = (k << (L + 1)) | best_v
                keys[m] = (np.int64(_KIND_FACE) << 62) | k

        return keys

    # ------------------------------------------------------------------
    # refinement
    # ------------------------------------------------------------------
    def refine_global(self, n: int = 1):
        for _ in range(n):
            self.execute_refinement(np.ones(len(self.root), dtype=bool))

    def balance_flags(self, flags: np.ndarray) -> np.ndarray:
        """Extend refine flags so the post-refinement mesh keeps 2:1 full
        balance (p4est CONNECT_FULL semantics: level difference <= 1
        between any two cells whose closures intersect).

        Precondition: the current mesh is balanced (maintained inductively).
        """
        flags = flags.copy()
        dim, S = self.dim, self.S
        n = len(self.root)
        W = (S >> self.level).astype(np.int64)

        # closure points at half-cell resolution: 3**dim per cell
        offs = np.array(
            np.meshgrid(*([np.array([0, 1, 2])] * dim), indexing="ij")
        ).reshape(dim, -1).T  # (3**dim, dim)
        pts = (self.anchor[:, None, :] + offs[None, :, :] * (W[:, None, None] // 2))
        roots_rep = np.repeat(self.root, len(offs))
        keys = self.canonical_keys(roots_rep, pts.reshape(-1, dim))
        cell_of_pt = np.repeat(np.arange(n), len(offs))

        order = np.argsort(keys, kind="stable")
        keys_s = keys[order]
        cells_s = cell_of_pt[order]
        grp = np.concatenate([[True], keys_s[1:] != keys_s[:-1]])
        gid = np.cumsum(grp) - 1
        n_groups = gid[-1] + 1 if len(gid) else 0

        while True:
            post = self.level + flags
            # max post level among cells sharing each key group
            gmax = np.full(n_groups, -1, dtype=np.int64)
            np.maximum.at(gmax, gid, post[cells_s])
            need = gmax[gid] > post[cells_s] + 1
            newly = np.zeros(n, dtype=bool)
            newly[cells_s[need]] = True
            newly &= ~flags
            if not newly.any():
                break
            flags |= newly
        return flags

    def execute_refinement(self, flags: np.ndarray):
        """Replace flagged cells by their 2**dim children (no balance here;
        call balance_flags first for adaptive refinement)."""
        if len(flags) != len(self.root):
            raise ValueError("flag array size mismatch")
        if (self.level[flags] >= self.max_level).any():
            raise RuntimeError("maximum refinement level exceeded")
        dim = self.dim
        keep = ~flags
        ref = flags
        nref = int(ref.sum())
        child_offs = np.array(
            np.meshgrid(*([np.array([0, 1])] * dim), indexing="ij")
        ).reshape(dim, -1).T[:, ::-1]  # lex order (x fastest)
        # note: meshgrid ij ordering gives x slowest; reverse columns so the
        # first axis varies fastest is not actually required for correctness
        # (children are unordered siblings), but keep deterministic.
        Wc = (self.S >> (self.level[ref] + 1)).astype(np.int64)
        new_anchor = (
            self.anchor[ref][:, None, :]
            + child_offs[None, :, :] * Wc[:, None, None]
        ).reshape(-1, dim)
        new_root = np.repeat(self.root[ref], 2 ** dim)
        new_level = np.repeat(self.level[ref] + 1, 2 ** dim)

        self.root = np.concatenate([self.root[keep], new_root])
        self.level = np.concatenate([self.level[keep], new_level.astype(np.int32)])
        self.anchor = np.concatenate([self.anchor[keep], new_anchor])
        self._sort_cells()
        return nref

    def _sort_cells(self):
        order = np.lexsort((self.level, _morton(self.anchor, self.dim), self.root))
        self.root = self.root[order]
        self.level = self.level[order]
        self.anchor = self.anchor[order]

    @property
    def n_cells(self) -> int:
        return len(self.root)

    # ------------------------------------------------------------------
    # mesh extraction
    # ------------------------------------------------------------------
    def _cell_corner_lattice(self):
        dim = self.dim
        W = (self.S >> self.level).astype(np.int64)
        corner_offs = np.zeros((2 ** dim, dim), dtype=np.int64)
        for c in range(2 ** dim):
            for d in range(dim):
                corner_offs[c, d] = (c >> d) & 1
        pts = self.anchor[:, None, :] + corner_offs[None, :, :] * W[:, None, None]
        return pts  # (n_cells, 2**dim, dim)

    def _physical(self, root: np.ndarray, coords: np.ndarray) -> np.ndarray:
        """Multilinear map of lattice coords [0,S]^dim to physical space."""
        dim = self.dim
        xi = coords.astype(np.float64) / self.S  # (n, dim)
        corners = self.coarse.vertices[self.coarse.cells[root]]  # (n, 2**dim, dim)
        w = np.ones((len(root), 2 ** dim), dtype=np.float64)
        for c in range(2 ** dim):
            wc = np.ones(len(root), dtype=np.float64)
            for d in range(dim):
                wc = wc * (xi[:, d] if ((c >> d) & 1) else (1.0 - xi[:, d]))
            w[:, c] = wc
        return np.einsum("nc,ncd->nd", w, corners)

    def extract(self) -> MeshData:
        """Build the flat MeshData arrays for the current active mesh."""
        dim, S = self.dim, self.S
        n = self.n_cells
        nv_cell = 2 ** dim

        lattice = self._cell_corner_lattice()             # (n, 2**dim, dim)
        roots_rep = np.repeat(self.root, nv_cell)
        flat = lattice.reshape(-1, dim)
        keys = self.canonical_keys(roots_rep, flat)

        vert_keys, first_idx, inverse = np.unique(
            keys, return_index=True, return_inverse=True)
        cell2vert = inverse.reshape(n, nv_cell).astype(np.int32)
        vert_coords = self._physical(roots_rep[first_idx], flat[first_idx])

        cell_coords = vert_coords[cell2vert]
        # diameter = largest diagonal (deal.II cell->diameter()); corners
        # are in lexicographic order so corner c pairs with corner
        # (2**dim - 1 - c).  Computing just the 2 (2d) / 4 (3d) diagonals
        # instead of all vertex pairs cuts ~5 s off refine-6 extraction.
        half = nv_cell // 2
        diag = cell_coords[:, :half, :] - cell_coords[:, nv_cell - 1:half - 1:-1, :]
        diameters = np.sqrt((diag ** 2).sum(-1)).max(axis=1)

        # --- hanging nodes ---
        edges = _EDGES_2D if dim == 2 else _EDGES_3D
        mids = []
        mvids = []
        for (a, b) in edges:
            pa, pb = lattice[:, a, :], lattice[:, b, :]
            mids.append((pa + pb) // 2)
            mvids.append(np.stack([cell2vert[:, a], cell2vert[:, b]], axis=1))
        mid_pts = np.concatenate(mids)             # (n*nedges, dim)
        mid_masters = np.concatenate(mvids)        # (n*nedges, 2)
        mid_roots = np.tile(self.root, len(edges))
        mid_keys = self.canonical_keys(mid_roots, mid_pts)
        pos = np.searchsorted(vert_keys, mid_keys)
        pos_clip = np.minimum(pos, len(vert_keys) - 1)
        is_active = vert_keys[pos_clip] == mid_keys
        h_child = pos_clip[is_active].astype(np.int32)
        h_masters = mid_masters[is_active]
        h_weights = np.full((len(h_child), 2), 0.5)

        children = [h_child]
        masters = [np.concatenate([h_masters, h_masters], axis=1)]
        weights = [np.concatenate([h_weights * 0.5, h_weights * 0.5], axis=1)]
        # note: pad 2-master constraints to 4 columns by duplicating each
        # master at half weight; the weighted sum is identical.

        if dim == 3:
            faces = face_vertices(3)
            c_pts = []
            c_vids = []
            for f in faces:
                pf = lattice[:, list(f), :]
                c_pts.append(pf.sum(axis=1) // 4)
                c_vids.append(cell2vert[:, list(f)])
            cen_pts = np.concatenate(c_pts)
            cen_masters = np.concatenate(c_vids)
            cen_roots = np.tile(self.root, len(faces))
            cen_keys = self.canonical_keys(cen_roots, cen_pts)
            pos = np.searchsorted(vert_keys, cen_keys)
            pos_clip = np.minimum(pos, len(vert_keys) - 1)
            is_active = vert_keys[pos_clip] == cen_keys
            children.append(pos_clip[is_active].astype(np.int32))
            masters.append(cen_masters[is_active])
            weights.append(np.full((int(is_active.sum()), 4), 0.25))

        hang_child = np.concatenate(children)
        hang_masters = np.concatenate(masters).astype(np.int32)
        hang_weights = np.concatenate(weights)
        # dedupe (an unbroken edge may be shared by several cells)
        if len(hang_child):
            _, uidx = np.unique(hang_child, return_index=True)
            hang_child = hang_child[uidx]
            hang_masters = hang_masters[uidx]
            hang_weights = hang_weights[uidx]

        # --- boundary faces ---
        W = (S >> self.level).astype(np.int64)
        bcell, bface, bid = [], [], []
        fverts = face_vertices(dim)
        for d in range(dim):
            for side in (0, 1):
                f = 2 * d + side
                if side == 0:
                    on = self.anchor[:, d] == 0
                else:
                    on = self.anchor[:, d] + W == S
                if not on.any():
                    continue
                cells_on = np.where(on)[0]
                shared = self.face_shared[self.root[cells_on], f]
                cells_b = cells_on[~shared]
                bcell.append(cells_b)
                bface.append(np.full(len(cells_b), f, dtype=np.int32))
                bid.append(self.face_bid[self.root[cells_b], f])
        bface_cell = (np.concatenate(bcell) if bcell else np.zeros(0, np.int64)).astype(np.int32)
        bface_face = np.concatenate(bface) if bface else np.zeros(0, np.int32)
        bface_id = np.concatenate(bid) if bid else np.zeros(0, np.int32)

        boundary_vertices: dict = {}
        for b in np.unique(bface_id):
            sel = bface_id == b
            vids = cell2vert[bface_cell[sel][:, None],
                             np.array(fverts)[bface_face[sel]]]
            boundary_vertices[int(b)] = np.unique(vids)

        return MeshData(
            dim=dim,
            cell2vert=cell2vert,
            vert_coords=vert_coords,
            cell_coords=cell_coords,
            cell_level=self.level.copy(),
            cell_root=self.root.copy(),
            diameters=diameters,
            vertex_keys=vert_keys,
            hang_child=hang_child,
            hang_masters=hang_masters,
            hang_weights=hang_weights,
            bface_cell=bface_cell,
            bface_face=bface_face,
            bface_id=bface_id,
            boundary_vertices=boundary_vertices,
        )

    # ------------------------------------------------------------------
    # multigrid hierarchy support
    # ------------------------------------------------------------------
    def truncated(self, lmax: int) -> "Forest":
        """A new forest with every cell coarsened to level <= lmax
        (the 'global coarsening' hierarchy for geometric multigrid).
        Truncation of a 2:1-balanced forest stays balanced."""
        f2 = Forest(self.coarse)
        lvl = np.minimum(self.level, lmax)
        W = (self.S >> lvl).astype(np.int64)
        anchor = (self.anchor // W[:, None]) * W[:, None]
        mort = _morton(anchor, self.dim)
        combo = np.stack([self.root, lvl.astype(np.int64), mort], axis=1)
        _, idx = np.unique(combo, axis=0, return_index=True)
        f2.root = self.root[idx]
        f2.level = lvl[idx].astype(np.int32)
        f2.anchor = anchor[idx]
        f2._sort_cells()
        return f2

    def halfgrid_stencils(self, mesh: MeshData):
        """Interpolation stencils at all half-grid points of the active
        cells: (keys (n*3^dim,), masters (n*3^dim, 2^dim) vertex ids,
        weights (n*3^dim, 2^dim))."""
        dim = self.dim
        W = (self.S >> self.level).astype(np.int64)
        offs = np.array(
            np.meshgrid(*([np.array([0, 1, 2])] * dim), indexing="ij")
        ).reshape(dim, -1).T
        pts = (self.anchor[:, None, :]
               + offs[None, :, :] * (W[:, None, None] // 2)).reshape(-1, dim)
        roots_rep = np.repeat(self.root, len(offs))
        keys = self.canonical_keys(roots_rep, pts)
        w1d = np.array([[1.0, 0.0], [0.5, 0.5], [0.0, 1.0]])
        wts = np.ones((len(offs), 2 ** dim))
        for c in range(2 ** dim):
            for d in range(dim):
                wts[:, c] *= w1d[offs[:, d], (c >> d) & 1]
        masters = np.repeat(mesh.cell2vert, len(offs), axis=0)
        weights = np.tile(wts, (self.n_cells, 1))
        return keys, masters, weights

    # ------------------------------------------------------------------
    # solution transfer
    # ------------------------------------------------------------------
    def refine_and_transfer(self, flags: np.ndarray, old_mesh: MeshData,
                            fields: list[np.ndarray]):
        """Refine (with balance), and transfer vertex-valued fields to the
        new mesh by Q1 interpolation (reference cracks.cc:4137-4159).

        Returns (new_mesh, new_fields, n_refined).
        """
        flags = self.balance_flags(flags.astype(bool))
        nref = int(flags.sum())
        if nref == 0:
            return old_mesh, fields, 0

        dim = self.dim
        # interpolation stencils from the refined parents: all half-grid
        # points of each refined parent, with weights over parent corners.
        ref_idx = np.where(flags)[0]
        W = (self.S >> self.level[ref_idx]).astype(np.int64)
        offs = np.array(
            np.meshgrid(*([np.array([0, 1, 2])] * dim), indexing="ij")
        ).reshape(dim, -1).T
        pts = (self.anchor[ref_idx][:, None, :]
               + offs[None, :, :] * (W[:, None, None] // 2)).reshape(-1, dim)
        roots_rep = np.repeat(self.root[ref_idx], len(offs))
        stencil_keys = self.canonical_keys(roots_rep, pts)
        # weights over parent corner vertices: product per dim of
        # off==0 -> (1,0); off==1 -> (.5,.5); off==2 -> (0,1)
        w1d = np.array([[1.0, 0.0], [0.5, 0.5], [0.0, 1.0]])
        wts = np.ones((len(offs), 2 ** dim))
        for c in range(2 ** dim):
            for d in range(dim):
                wts[:, c] *= w1d[offs[:, d], (c >> d) & 1]
        parent_verts = old_mesh.cell2vert[ref_idx]        # (nref, 2**dim)
        stencil_masters = np.repeat(parent_verts, len(offs), axis=0)
        stencil_weights = np.tile(wts, (nref, 1))

        self.execute_refinement(flags)
        new_mesh = self.extract()

        # transfer
        old_keys = old_mesh.vertex_keys
        pos = np.searchsorted(old_keys, new_mesh.vertex_keys)
        pos_clip = np.minimum(pos, len(old_keys) - 1)
        found = old_keys[pos_clip] == new_mesh.vertex_keys

        skeys, sidx = np.unique(stencil_keys, return_index=True)
        spos = np.searchsorted(skeys, new_mesh.vertex_keys)
        spos_clip = np.minimum(spos, len(skeys) - 1)
        sfound = skeys[spos_clip] == new_mesh.vertex_keys
        need = ~found
        if (need & ~sfound).any():
            raise RuntimeError("solution transfer: new vertex without parent")

        new_fields = []
        for f in fields:
            shape = (new_mesh.n_vertices,) + f.shape[1:]
            out = np.zeros(shape, dtype=f.dtype)
            out[found] = f[pos_clip[found]]
            m = stencil_masters[sidx[spos_clip[need]]]
            w = stencil_weights[sidx[spos_clip[need]]]
            vals = np.einsum("nc,nc...->n...", w, f[m])
            out[need] = vals
            new_fields.append(out)
        return new_mesh, new_fields, nref


def forest_from_mesh_info(coarse: CoarseMesh, n_global_refine: int = 0) -> tuple:
    """Convenience: build forest, apply global refinement, extract."""
    forest = Forest(coarse)
    forest.refine_global(n_global_refine)
    return forest, forest.extract()


def interpolation_stencil(coarse_forest: Forest, coarse_mesh: MeshData,
                          fine_mesh: MeshData):
    """Q1 interpolation stencil from a coarse mesh to a finer refinement
    of it: for every fine vertex, up to 2^dim coarse master vertices and
    weights.  Coarse vertices map to themselves (identity stencil).

    Returns (masters (n_fine_v, 2^dim) int32, weights (n_fine_v, 2^dim)).
    """
    dim = coarse_mesh.dim
    nvc = 2 ** dim
    n_f = fine_mesh.n_vertices
    masters = np.zeros((n_f, nvc), dtype=np.int64)
    weights = np.zeros((n_f, nvc))

    ckeys = coarse_mesh.vertex_keys
    pos = np.searchsorted(ckeys, fine_mesh.vertex_keys)
    pos_c = np.minimum(pos, len(ckeys) - 1)
    is_coarse = ckeys[pos_c] == fine_mesh.vertex_keys
    masters[is_coarse, 0] = pos_c[is_coarse]
    weights[is_coarse, 0] = 1.0

    need = ~is_coarse
    if need.any():
        skeys, smasters, sweights = coarse_forest.halfgrid_stencils(coarse_mesh)
        uk, uidx = np.unique(skeys, return_index=True)
        spos = np.searchsorted(uk, fine_mesh.vertex_keys[need])
        spos_c = np.minimum(spos, len(uk) - 1)
        found = uk[spos_c] == fine_mesh.vertex_keys[need]
        if not found.all():
            raise RuntimeError("fine mesh is not a refinement of the coarse")
        sel = uidx[spos_c]
        masters[need] = smasters[sel]
        weights[need] = sweights[sel]
    return masters.astype(np.int32), weights
