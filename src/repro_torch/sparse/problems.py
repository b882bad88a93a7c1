"""Stencil / structured problem generators (port of
:mod:`repro.sparse.problems`).

The five numpy generators (``poisson_2d``, ``poisson_3d``, ``banded``,
``random_spd_sparse``, ``smooth_rhs``) are copies of the reference's and
return the same arrays, bit for bit: the 2-D/3-D Poisson operators are the
canonical SPD model problems of the sparse-solver literature the paper's
iterative methods were built for.  They return *dense* numpy matrices;
convert with ``BSR.from_dense`` / ``ELL.from_dense``.

:func:`poisson_3d_bsr` assembles the BSR of ``BSR.from_dense(poisson_3d(m),
block_size=nb)`` directly, in O(nnz) and without the dense n × n matrix, so
that grids of 128³ (n ≈ 2.1 M) fit: the structure comes from numpy and the
brick values are four template bricks indexed on the device.
"""
from __future__ import annotations

import numpy as np


def _tridiag(n: int, dtype) -> np.ndarray:
    """The 1-D Dirichlet Laplacian tridiag(-1, 2, -1)."""
    t = 2.0 * np.eye(n, dtype=dtype)
    off = -np.eye(n, k=1, dtype=dtype)
    return t + off + off.T


def poisson_2d(nx: int, ny: int | None = None,
               dtype=np.float32) -> np.ndarray:
    """5-point finite-difference Laplacian on an ``nx × ny`` grid
    (Dirichlet): ``A = I ⊗ T + T ⊗ I``, SPD, n = nx·ny, ≤ 5 nnz/row."""
    ny = nx if ny is None else ny
    tx, ty = _tridiag(nx, dtype), _tridiag(ny, dtype)
    a = np.kron(np.eye(ny, dtype=dtype), tx) \
        + np.kron(ty, np.eye(nx, dtype=dtype))
    return a.astype(dtype)


def poisson_3d(nx: int, ny: int | None = None, nz: int | None = None,
               dtype=np.float32) -> np.ndarray:
    """7-point Laplacian on an ``nx × ny × nz`` grid, n = nx·ny·nz."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    ix, iy, iz = (np.eye(m, dtype=dtype) for m in (nx, ny, nz))
    a = np.kron(np.kron(iz, iy), _tridiag(nx, dtype)) \
        + np.kron(np.kron(iz, _tridiag(ny, dtype)), ix) \
        + np.kron(np.kron(_tridiag(nz, dtype), iy), ix)
    return a.astype(dtype)


def banded(n: int, bandwidth: int = 8, dtype=np.float32,
           seed: int = 0) -> np.ndarray:
    """Random symmetric banded matrix, made SPD by diagonal dominance
    (diag = 1 + Σ|off-diag| per row)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), dtype)
    for k in range(1, bandwidth + 1):
        band = rng.standard_normal(n - k).astype(dtype)
        a += np.diag(band, k) + np.diag(band, -k)
    np.fill_diagonal(a, 1.0 + np.abs(a).sum(axis=1))
    return a.astype(dtype)


def random_spd_sparse(n: int, density: float = 0.02, dtype=np.float32,
                      seed: int = 0) -> np.ndarray:
    """Random sparse SPD matrix: symmetric Erdős–Rényi off-diagonal pattern
    at roughly ``density``, diagonally dominant."""
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density={density} must be in (0, 1]")
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density / 2.0    # symmetrized below → ρ
    vals = rng.standard_normal((n, n)).astype(dtype) * mask
    a = vals + vals.T
    np.fill_diagonal(a, 0.0)
    np.fill_diagonal(a, 1.0 + np.abs(a).sum(axis=1))
    return a.astype(dtype)


def smooth_rhs(n: int, dtype=np.float32, seed: int = 0) -> np.ndarray:
    """A smooth right-hand side (superposed low-frequency sines plus a
    small random component) — the forcing profile Poisson benchmarks use;
    smoothness keeps ‖x‖/‖b‖ moderate, which tightens parity tests."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, n, dtype=np.float64)
    b = np.sin(np.pi * t) + 0.5 * np.sin(3 * np.pi * t) \
        + 0.1 * rng.standard_normal(n)
    return (b / np.linalg.norm(b)).astype(dtype)


# brick kinds of the 7-point stencil at brick granularity, in block-column
# order: z−1, y−1, x−1, diagonal, x+1, y+1, z+1
_NEG_EYE, _LEFT, _DIAG, _RIGHT = 0, 1, 2, 3
_SLOT_KINDS = np.array([_NEG_EYE, _NEG_EYE, _LEFT, _DIAG, _RIGHT, _NEG_EYE,
                        _NEG_EYE], np.int64)


def _poisson_3d_structure(nx: int, block_size: int = 32, dtype=np.float32):
    """The BSR structure of ``poisson_3d(nx)`` at brick size
    ``block_size`` (which must divide ``nx``): ``(indices, indptr, kinds,
    templates)``.  Entry e of the BSR holds brick ``templates[kinds[e]]``;
    the four templates are −I (y and z neighbours), the x−1 and x+1 corner
    bricks, and the diagonal brick tridiag(−1, 6, −1)."""
    nb = int(block_size)
    if nx < 1 or nb < 1 or nx % nb:
        raise ValueError(f"block_size={block_size} must divide nx={nx}")
    lines = nx // nb                          # bricks per x-line
    nbr = nx * nx * lines
    r = np.arange(nbr, dtype=np.int64)
    xb, y, z = r % lines, (r // lines) % nx, r // (lines * nx)
    offsets = np.array([-lines * nx, -lines, -1, 0, 1, lines, lines * nx])
    present = np.stack([z > 0, y > 0, xb > 0, np.ones(nbr, bool),
                        xb < lines - 1, y < nx - 1, z < nx - 1], axis=1)
    indices = (r[:, None] + offsets)[present]
    kinds = np.broadcast_to(_SLOT_KINDS, present.shape)[present]
    indptr = np.concatenate([[0], np.cumsum(present.sum(axis=1))])
    templates = np.zeros((4, nb, nb), dtype)
    templates[_NEG_EYE] = -np.eye(nb, dtype=dtype)
    templates[_LEFT, 0, nb - 1] = -1
    templates[_RIGHT, nb - 1, 0] = -1
    templates[_DIAG] = 6 * np.eye(nb, dtype=dtype) \
        - np.eye(nb, k=1, dtype=dtype) - np.eye(nb, k=-1, dtype=dtype)
    return (indices.astype(np.int32), indptr.astype(np.int32), kinds,
            templates)


def poisson_3d_bsr(nx: int, block_size: int = 32, dtype=np.float32, *,
                   device=None):
    """``BSR.from_dense(poisson_3d(nx), block_size)`` without the dense
    matrix: the same ``data``, ``indices`` and ``indptr``.  ``device`` as
    for every entry point (``None`` → ``"cuda"``)."""
    import torch

    from repro_torch import device as _device
    from repro_torch.sparse.formats import BSR
    dev = _device.resolve(device)
    indices, indptr, kinds, templates = _poisson_3d_structure(
        nx, block_size, dtype)
    data = torch.from_numpy(templates).to(dev)[torch.from_numpy(kinds)
                                               .to(dev)]
    n = nx ** 3
    return BSR(data, indices, indptr, (n, n), block_size, device=dev)
