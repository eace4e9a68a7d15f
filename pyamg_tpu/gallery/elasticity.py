"""Linear elasticity problems (Q1 on regular grids, P1 on simplex meshes).

Reference parity: pyamg/gallery/elasticity.py (``linear_elasticity`` :13,
``linear_elasticity_p1`` :215).  Assembly here is quadrature-based isotropic
elasticity (plane strain in 2D):

    K[(i,a),(j,b)] = ∫ λ ∂_a φ_i ∂_b φ_j + μ ∂_b φ_i ∂_a φ_j
                       + μ δ_ab ∇φ_i·∇φ_j dx
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp

from ._fem import _GAUSS_2, q1_shape_grads

__all__ = ["linear_elasticity", "linear_elasticity_p1"]


def _elastic_block(gi: np.ndarray, gj: np.ndarray, lame: float, mu: float,
                   d: int) -> np.ndarray:
    """d×d DOF coupling block for shape-function gradients gi, gj."""
    blk = lame * np.outer(gi, gj) + mu * np.outer(gj, gi)
    blk += mu * float(gi @ gj) * np.eye(d)
    return blk


def q1_elasticity_element(spacing, lame: float, mu: float) -> np.ndarray:
    """Local stiffness for Q1 elasticity on a d-cube; DOFs interleaved."""
    h = np.asarray(spacing, dtype=float)
    d = h.size
    nv = 2**d
    K = np.zeros((nv * d, nv * d))
    pts, wts = _GAUSS_2
    detJ = float(np.prod(h))
    for q in itertools.product(range(2), repeat=d):
        xi = np.array([pts[qi] for qi in q])
        w = float(np.prod([wts[qi] for qi in q])) * detJ
        _, g = q1_shape_grads(xi, d)
        g = g / h[None, :]
        for i in range(nv):
            for j in range(nv):
                K[i * d:(i + 1) * d, j * d:(j + 1) * d] += (
                    w * _elastic_block(g[i], g[j], lame, mu, d))
    return K


def linear_elasticity(grid, spacing=None, E=1e5, nu=0.3, format=None):
    """Q1 linear elasticity on a regular 2D grid with Dirichlet boundary.

    Returns (A, B): the stiffness matrix (BSR, blocksize 2, one block per
    interior node — ``grid`` counts interior nodes per dimension) and the
    3 rigid-body modes evaluated at the node coordinates.

    Assembly exploits the uniform mesh: every interior lattice node sees
    all 4 adjacent elements, so the assembled operator is a uniform
    9-point 2x2-block stencil (couplings to boundary nodes simply drop in
    the Dirichlet restriction).  The BSR arrays are written directly in
    sorted order — no element COO, no duplicate summing, no fancy-index
    restriction (~4x over the generic path; same trick as stencil_grid).

    Examples
    --------
    >>> from pyamg_tpu.gallery import linear_elasticity
    >>> A, B = linear_elasticity((4, 4))
    >>> A.shape, B.shape
    ((32, 32), (32, 3))
    """
    grid = tuple(int(g) for g in grid)
    if len(grid) != 2:
        raise NotImplementedError(f"only 2D supported, got grid={grid}")
    nx, ny = grid
    if nx < 1 or ny < 1:
        raise ValueError("invalid grid shape")

    if spacing is None:
        hx, hy = 1.0, 1.0
    else:
        hx, hy = (float(s) for s in spacing)

    lame = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 + 2 * nu)
    K = q1_elasticity_element((hx, hy), lame, mu)

    d = 2
    # accumulated node-to-node stencil blocks: for neighbor offset o, sum
    # K[a, b] over local vertex pairs a, b = a + o shared by an element
    # (vertex binary order (0,0),(0,1),(1,0),(1,1) — axis 0 is the msb)
    vert = np.array([(0, 0), (0, 1), (1, 0), (1, 1)])
    vidx = {tuple(v): i for i, v in enumerate(vert)}
    Kb = K.reshape(4, d, 4, d).transpose(0, 2, 1, 3)    # (a, b, d, d)
    offs = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
    S = np.zeros((9, d, d))
    for oi, (dx, dy) in enumerate(offs):
        for a, va in enumerate(vert):
            vb = (va[0] + dx, va[1] + dy)
            b = vidx.get(vb)
            if b is not None:
                S[oi] += Kb[a, b]

    # direct sorted BSR assembly over the interior node grid: offsets in
    # lexicographic (dx, dy) order give strictly increasing column indices
    # within each row
    n = nx * ny
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    cols = np.empty((n, 9), dtype=np.int64)
    valid = np.empty((n, 9), dtype=bool)
    for oi, (dx, dy) in enumerate(offs):
        ci, cj = ii + dx, jj + dy
        valid[:, oi] = (0 <= ci) & (ci < nx) & (0 <= cj) & (cj < ny)
        cols[:, oi] = ci * ny + cj
    mask = valid.ravel()
    indices = cols.ravel()[mask]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=indptr[1:])
    # gather only the kept blocks by stencil-slot id (a reshape of the
    # broadcast view would materialize all 9n blocks first)
    slot = np.tile(np.arange(9), n)[mask]
    A = sp.bsr_matrix((S[slot], indices, indptr), shape=(d * n, d * n))

    # rigid body modes at the interior node coordinates (lattice centered
    # at the origin: interior node (i, j) sits at ((i+1) - (nx+1)/2) * h)
    xs = (np.arange(1, nx + 1) - (nx + 1) / 2.0) * hx
    ys = (np.arange(1, ny + 1) - (ny + 1) / 2.0) * hy
    px, py = np.meshgrid(xs, ys, indexing="ij")
    B = np.zeros((d * n, 3))
    B[0::2, 0] = 1
    B[1::2, 1] = 1
    B[0::2, 2] = -py.reshape(-1)
    B[1::2, 2] = px.reshape(-1)

    A = A.asformat(format) if format else A
    A.grid = grid       # node-grid metadata for the structured device path
    return A, B


def _p1_local(verts: np.ndarray, lame: float, mu: float) -> np.ndarray:
    """Local stiffness for a P1 simplex with vertex coords ``verts``."""
    import math

    verts = np.asarray(verts, dtype=float)
    d = verts.shape[1]
    T = (verts[1:] - verts[0]).T          # (d, d)
    vol = abs(np.linalg.det(T)) / math.factorial(d)
    Tinv = np.linalg.inv(T)
    g = np.zeros((d + 1, d))
    g[1:] = Tinv          # ∇φ_k = row k-1 of T^{-1} (ξ = T^{-1}(x - x0))
    g[0] = -g[1:].sum(axis=0)
    nv = d + 1
    K = np.zeros((nv * d, nv * d))
    for i in range(nv):
        for j in range(nv):
            K[i * d:(i + 1) * d, j * d:(j + 1) * d] = (
                vol * _elastic_block(g[i], g[j], lame, mu, d))
    return K


def linear_elasticity_p1(vertices, elements, E=1e5, nu=0.3, format=None):
    """P1 linear elasticity on a triangle (2D) or tet (3D) mesh.

    Returns (A, B) with A in BSR blocksize d and B the d(d+1)/2 + d rigid
    body modes.
    """
    vertices = np.asarray(vertices, dtype=float)
    elements = np.asarray(elements, dtype=np.int64)
    d = vertices.shape[1]
    if d not in (2, 3):
        raise ValueError("only 2D/3D meshes supported")
    if elements.shape[1] != d + 1:
        raise ValueError("elements must be simplices (d+1 vertices)")

    lame = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 + 2 * nu)

    nv = d + 1
    ne = elements.shape[0]
    rows, cols, vals = [], [], []
    for e in range(ne):
        Ke = _p1_local(vertices[elements[e]], lame, mu)
        dof = (d * elements[e][:, None] + np.arange(d)[None, :]).reshape(-1)
        I = np.repeat(dof, nv * d)
        J = np.tile(dof, nv * d)
        rows.append(I)
        cols.append(J)
        vals.append(Ke.ravel())

    n = d * vertices.shape[0]
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tobsr(blocksize=(d, d))

    from ..util.utils import coord2rbm
    B = coord2rbm(vertices)
    return (A.asformat(format) if format else A), B
