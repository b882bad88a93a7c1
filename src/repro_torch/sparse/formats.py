"""Sparse matrix containers: BSR (block-CSR) and ELL (padded) formats (port of
:mod:`repro.sparse.formats`).

* :class:`BSR` — block compressed sparse row.  Nonzeros are stored as dense
  ``nb × nb`` bricks in ``data`` (nnzb, nb, nb), a torch tensor; the
  structure (``indices``, ``indptr``) is numpy ``int32``, as in the
  reference.  The hand-written SpMV kernel (:mod:`repro_torch.kernels.spmv`)
  reads device ``int32`` copies of the structure, ``indices_dev`` and
  ``indptr_dev``, made once at construction (or by :meth:`BSR.to`), never
  per product.
* :class:`ELL` — ELLPACK: every row padded to the same number of scalar
  nonzeros.

Sizes that do not divide the brick size are identity/zero padded with the
exact policy of the dense path (:mod:`repro_torch.core.blocking`): the
padded operator is ``[[A, 0], [0, I]]``, pads contribute zeros to every
product and are sliced away, so ``from_dense`` / ``to_dense`` round-trip
the logical ``n``.

The plain products (``matvec`` / ``matvec_t``) are deterministic on every
device: each block row's bricks are placed in the padded blocked-ELL slots
of :meth:`BSR.ell_layout` (one writer per slot) and summed over the slot
axis, where the reference's ``segment_sum`` would become an atomic
``index_add_`` on CUDA.

Entry points run on the GPU: the constructors and ``from_dense`` take
``device=None``, which means ``"cuda"`` and raises without a GPU; the tests
pass ``device="cpu"``.

The reference's ``_Static`` wrapper and pytree registration exist so that a
BSR crosses ``jax.jit`` boundaries with its structure as static aux data.
PyTorch runs eagerly and the port has no ``jit``, so they have no
counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch.core import blocking


class SparseMatrix:
    """Marker base: ``getattr(a, "is_sparse", False)`` is the dispatch test
    used by :mod:`repro_torch.core.api` / ``make_operator`` /
    ``precond.make``."""

    is_sparse = True
    ndim = 2

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def matvec(self, x):
        raise NotImplementedError

    def matvec_t(self, x):
        raise NotImplementedError

    def __matmul__(self, x):
        return self.matvec(x)


def _as_concrete(a, square: bool = True) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    if a.ndim != 2 or (square and a.shape[0] != a.shape[1]):
        want = "a square (n, n)" if square else "a 2-D (m, n)"
        raise ValueError(f"expected {want} matrix, got {a.shape}")
    if not np.issubdtype(a.dtype, np.floating):
        raise ValueError(f"expected a floating dtype, got {a.dtype}")
    return a


def _data_tensor(data, dev: torch.device) -> torch.Tensor:
    if isinstance(data, np.ndarray):
        data = torch.from_numpy(np.array(data, order="C"))    # a copy
    return torch.as_tensor(data, device=dev).contiguous()


def _is_on(dev: torch.device, current: torch.device) -> bool:
    """Whether ``dev`` names ``current`` (``"cuda"`` names ``cuda:0``)."""
    return dev == current or (dev.index is None and dev.type == current.type)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _slot_table(groups: np.ndarray, nseg: int) -> tuple[np.ndarray, int]:
    """For entries sorted by ``groups`` (non-decreasing segment ids), each
    entry's flat slot ``segment · width + rank within its segment`` and the
    width (the longest segment, at least 1)."""
    counts = np.bincount(groups, minlength=nseg)
    width = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(groups.size) - starts[groups]
    return groups.astype(np.int64) * width + rank, width


def _segment_sum(contrib: torch.Tensor, slots: torch.Tensor, nseg: int,
                 width: int) -> torch.Tensor:
    """Sum the rows of ``contrib`` (E, ...) into ``nseg`` segments, each
    row written to its own slot of a zero (nseg·width, ...) buffer (one
    writer per slot) and the slots summed in index order."""
    buf = contrib.new_zeros((nseg * width,) + tuple(contrib.shape[1:]))
    buf.index_copy_(0, slots, contrib)
    return buf.reshape((nseg, width) + tuple(contrib.shape[1:])).sum(1)


class BSR(SparseMatrix):
    """Block-CSR: ``data[e]`` is the ``nb × nb`` brick at block-row
    ``row_ids[e]``, block-col ``indices[e]``; block-row r owns entries
    ``indptr[r]:indptr[r+1]``.  Structure is numpy, values a torch tensor
    on ``device`` (``None`` → ``"cuda"``)."""

    def __init__(self, data, indices, indptr, shape, nb, *, device=None):
        dev = _device.resolve(device)
        self.data = _data_tensor(data, dev)
        self.indices = np.array(indices, np.int32)     # own copies
        self.indptr = np.array(indptr, np.int32)
        self.shape = tuple(int(s) for s in shape)
        self.nb = int(nb)
        # rows and columns pad independently (rectangular (m, n) BSR maps
        # n-space to m-space); for square matrices the two coincide
        self.n_pad = blocking.padded_size(self.shape[0], self.nb)
        self.n_pad_cols = blocking.padded_size(self.shape[1], self.nb)
        self.nbr = self.n_pad // self.nb
        self.nbc = self.n_pad_cols // self.nb
        if tuple(self.data.shape[1:]) != (self.nb, self.nb):
            raise ValueError(f"bricks must be ({nb}, {nb}), got "
                             f"{tuple(self.data.shape[1:])}")
        if len(self.indptr) != self.nbr + 1 or self.indptr[0] != 0 \
                or self.indptr[-1] != self.data.shape[0]:
            raise ValueError("indptr inconsistent with data/nbr")
        if np.any(np.diff(self.indptr) < 0):
            raise ValueError("indptr must be non-decreasing")
        if self.indices.size and (self.indices.min() < 0
                                  or self.indices.max() >= self.nbc):
            raise ValueError("block-column indices out of range")
        # per-entry block-row ids (the segments of the row reduction)
        self.row_ids = np.repeat(np.arange(self.nbr, dtype=np.int32),
                                 np.diff(self.indptr))
        self._layout = None       # lazy padded (blocked-ELL) view
        self._slots_t = None      # lazy column slots of matvec_t
        # device copies of the structure, made once: the kernel's int32
        # tables and the plain product's gather and slot indices
        self.indices_dev = torch.from_numpy(self.indices).to(dev)
        self.indptr_dev = torch.from_numpy(self.indptr).to(dev)
        slots, self._width = _slot_table(self.row_ids, self.nbr)
        self._slots = torch.from_numpy(slots).to(dev)
        self._row_ids_dev = torch.from_numpy(self.row_ids).to(dev)
        for arr in (self.indices, self.indptr, self.row_ids):
            arr.setflags(write=False)

    def to(self, device) -> "BSR":
        """This matrix on ``device``, data and structure (``self`` when it
        is already there)."""
        dev = _device.resolve(device)
        if _is_on(dev, self.device):
            return self
        return BSR(self.data.to(dev), self.indices, self.indptr, self.shape,
                   self.nb, device=dev)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dense(cls, a, block_size: int = 32, *, device=None) -> "BSR":
        """Convert a dense matrix (numpy array or tensor); bricks that are
        entirely zero are dropped (diagonal bricks are always kept so the
        preconditioner extractions are well defined).  ``n % nb`` is
        handled by the identity-pad policy of
        :mod:`repro_torch.core.blocking`; rectangular (m, n) matrices pad
        rows and columns independently with zeros."""
        a = _as_concrete(a, square=False)
        m, n = a.shape
        square = m == n
        nb = blocking.choose_block(min(m, n), block_size)
        m_pad = blocking.padded_size(m, nb)
        n_pad = blocking.padded_size(n, nb)
        if (m_pad, n_pad) != (m, n):
            ap = np.zeros((m_pad, n_pad), a.dtype)
            ap[:m, :n] = a
            if square:        # [[A, 0], [0, I]] — blocking.pad_system
                ap[range(n, n_pad), range(n, n_pad)] = 1
            a = ap
        kr, kc = m_pad // nb, n_pad // nb
        bricks = a.reshape(kr, nb, kc, nb).transpose(0, 2, 1, 3)
        mask = np.abs(bricks).max(axis=(2, 3)) > 0
        kd = min(kr, kc)
        mask[np.arange(kd), np.arange(kd)] = True      # keep diagonal
        rows, cols = np.nonzero(mask)                  # row-major order
        indptr = np.zeros(kr + 1, np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(bricks[mask], cols, indptr, (m, n), nb, device=device)

    def to_dense(self) -> torch.Tensor:
        full = self.data.new_zeros((self.nbr, self.nbc, self.nb, self.nb))
        full[self._row_ids_dev.long(), self.indices_dev.long()] = self.data
        dense = full.permute(0, 2, 1, 3).reshape(self.n_pad, self.n_pad_cols)
        return dense[:self.shape[0], :self.shape[1]]

    # -- algebra (the plain products the kernel is held against) -----------
    def _blocks(self, x: torch.Tensor, pad_to: int | None = None):
        """Zero-pad a global column-space (n,) / (n, k) operand into
        (nbc, nb, k) bricks (``pad_to`` overrides for row-space input)."""
        pad_to = self.n_pad_cols if pad_to is None else pad_to
        xk = x[:, None] if x.ndim == 1 else x
        xp = F.pad(xk, (0, 0, 0, pad_to - xk.shape[0]))
        return xp.reshape(pad_to // self.nb, self.nb, xk.shape[1])

    def _unblocks(self, yb: torch.Tensor, x: torch.Tensor,
                  rows: int | None = None):
        rows = self.shape[0] if rows is None else rows
        y = yb.reshape(-1, yb.shape[-1])[:rows]
        return y[:, 0] if x.ndim == 1 else y

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x for x of shape (n,) or (n, k): one gather of x blocks,
        one batched brick product, one slot-ordered row reduction."""
        xb = self._blocks(x)
        contrib = torch.bmm(self.data, xb.index_select(0, self.indices_dev))
        yb = _segment_sum(contrib, self._slots, self.nbr, self._width)
        return self._unblocks(yb, x)

    def matvec_t(self, x: torch.Tensor) -> torch.Tensor:
        """y = Aᵀ x (x in the row space, result in the column space): the
        dual gather, with entries grouped by block column."""
        if self._slots_t is None:
            order = np.lexsort((self.row_ids, self.indices))
            slots, width = _slot_table(self.indices[order], self.nbc)
            inverse = np.empty_like(slots)
            inverse[order] = slots
            self._slots_t = (torch.from_numpy(inverse).to(self.device), width)
        slots, width = self._slots_t
        xb = self._blocks(x, pad_to=self.n_pad)
        contrib = torch.bmm(self.data.transpose(1, 2),
                            xb.index_select(0, self._row_ids_dev))
        yb = _segment_sum(contrib, slots, self.nbc, width)
        return self._unblocks(yb, x, rows=self.shape[1])

    def transpose(self) -> "BSR":
        """Aᵀ as a BSR on the same device: bricks permuted into
        column-major-becomes-row-major order and each brick transposed."""
        perm = np.lexsort((self.row_ids, self.indices))
        indices_t = self.row_ids[perm]
        indptr_t = np.concatenate(
            [[0], np.cumsum(np.bincount(self.indices, minlength=self.nbc))])
        data_t = self.data[torch.from_numpy(perm).to(self.device)]
        return BSR(data_t.transpose(1, 2), indices_t, indptr_t,
                   (self.shape[1], self.shape[0]), self.nb,
                   device=self.device)

    @property
    def T(self) -> "BSR":
        return self.transpose()

    # -- structure views ---------------------------------------------------
    def _diag_map(self) -> tuple[np.ndarray, np.ndarray]:
        """Per block row, the entry of its diagonal brick (the first, where
        a hand-built structure repeats it) and whether there is one."""
        hits = np.nonzero(self.indices == self.row_ids)[0]
        rows, first = np.unique(self.row_ids[hits], return_index=True)
        diag_map = np.zeros(self.nbr, np.int32)
        present = np.zeros(self.nbr, bool)
        diag_map[rows], present[rows] = hits[first], True
        return diag_map, present

    def block_diagonal(self) -> torch.Tensor:
        """The (nbr, nb, nb) diagonal bricks (zero brick where absent) —
        the matrix-free source for Jacobi / block-Jacobi / SSOR."""
        diag_map, present = self._diag_map()
        bricks = self.data[torch.from_numpy(diag_map).to(self.device).long()]
        keep = torch.from_numpy(present).to(self.device)[:, None, None]
        return torch.where(keep, bricks, torch.zeros_like(bricks))

    def diagonal(self) -> torch.Tensor:
        """The point diagonal of the logical (n, n) matrix."""
        d = torch.diagonal(self.block_diagonal(), dim1=-2, dim2=-1)
        return d.reshape(self.n_pad)[:self.shape[0]]

    def ell_layout(self):
        """Padded blocked-ELL view: numpy ``(brick_map, col_map, valid)``
        of shape (nbr, max_blk) — pad slots point at brick 0 / col 0 with
        valid 0 (contribute 0)."""
        if self._layout is None:
            shape = (self.nbr, self._width)
            entries = np.arange(self.indices.size)
            rank = entries - self.indptr[self.row_ids]
            brick_map = np.zeros(shape, np.int32)
            col_map = np.zeros(shape, np.int32)
            valid = np.zeros(shape, np.int32)
            brick_map[self.row_ids, rank] = entries
            col_map[self.row_ids, rank] = self.indices
            valid[self.row_ids, rank] = 1
            self._layout = (brick_map, col_map, valid)
        return self._layout

    def padded_data(self) -> torch.Tensor:
        """Bricks gathered into the (nbr, max_blk, nb, nb) blocked-ELL
        layout, pad slots zeroed."""
        brick_map, _, valid = self.ell_layout()
        dev = self.device
        bricks = self.data[torch.from_numpy(brick_map).to(dev).long()]
        return bricks * torch.from_numpy(valid).to(
            dev, self.data.dtype)[:, :, None, None]

    # -- stats -------------------------------------------------------------
    @property
    def nnz(self) -> int:
        """Stored entries (brick granularity): nnzb · nb²."""
        return int(self.data.shape[0]) * self.nb * self.nb

    @property
    def density(self) -> float:
        return self.nnz / (self.shape[0] * self.shape[1])

    def __repr__(self):
        return (f"BSR(shape={self.shape}, nb={self.nb}, "
                f"nnzb={self.data.shape[0]}, "
                f"dtype={_dtype_name(self.data.dtype)})")


class ELL(SparseMatrix):
    """ELLPACK: every row padded to ``max_nnz`` scalar entries.  ``cols`` /
    ``valid`` are numpy; pad slots carry value 0 at col 0."""

    def __init__(self, data, cols, valid, shape, *, device=None):
        dev = _device.resolve(device)
        self.data = _data_tensor(data, dev)
        self.cols = np.array(cols, np.int32)
        self.valid = np.array(valid, bool)
        self.shape = tuple(int(s) for s in shape)
        n = self.shape[0]
        if tuple(self.data.shape) != self.cols.shape or \
                self.valid.shape != self.cols.shape:
            raise ValueError("data / cols / valid shapes must match")
        if self.data.shape[0] != n:
            raise ValueError(f"expected {n} rows, got {self.data.shape[0]}")
        if self.cols.size and (self.cols.min() < 0
                               or self.cols.max() >= self.shape[1]):
            raise ValueError("column indices out of range")
        self._row_ids = np.repeat(np.arange(n, dtype=np.int32),
                                  self.cols.shape[1])
        self._cols_dev = torch.from_numpy(self.cols).to(dev).long()
        self._mask = torch.from_numpy(self.valid).to(dev)
        self._gather_t = None     # lazy column-grouped entry table
        for arr in (self.cols, self.valid):
            arr.setflags(write=False)

    def to(self, device) -> "ELL":
        """This matrix on ``device`` (``self`` when it is already there)."""
        dev = _device.resolve(device)
        if _is_on(dev, self.device):
            return self
        return ELL(self.data.to(dev), self.cols, self.valid, self.shape,
                   device=dev)

    @classmethod
    def from_dense(cls, a, max_nnz: int | None = None, *,
                   device=None) -> "ELL":
        a = _as_concrete(a)
        n = a.shape[0]
        nz = a != 0
        counts = nz.sum(axis=1)
        width = max(int(counts.max()) if n else 0, 1)
        if max_nnz is not None:
            if max_nnz < width:
                raise ValueError(f"max_nnz={max_nnz} < densest row ({width})")
            width = max_nnz
        rows, c = np.nonzero(nz)                       # row-major order
        rank = np.arange(rows.size) - np.concatenate(
            [[0], np.cumsum(counts)[:-1]])[rows]
        cols = np.zeros((n, width), np.int32)
        valid = np.zeros((n, width), bool)
        data = np.zeros((n, width), a.dtype)
        cols[rows, rank] = c
        valid[rows, rank] = True
        data[rows, rank] = a[rows, c]
        return cls(data, cols, valid, a.shape, device=device)

    def _values(self) -> torch.Tensor:
        return self.data * self._mask.to(self.data.dtype)

    def to_dense(self) -> torch.Tensor:
        dense = self.data.new_zeros(self.shape)
        rows = torch.from_numpy(self._row_ids).to(self.device).long()
        # pad slots add an exact 0 at column 0, so the sum is exact in any
        # order
        return dense.index_put_((rows, self._cols_dev.reshape(-1)),
                                self._values().reshape(-1), accumulate=True)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        vals = self._values()
        if x.ndim == 1:
            return (vals * x[self._cols_dev]).sum(dim=1)
        return torch.einsum("rm,rmk->rk", vals, x[self._cols_dev])

    def matvec_t(self, x: torch.Tensor) -> torch.Tensor:
        """y = Aᵀ x: each column's entries gathered into its own padded row
        and summed in order (no atomics)."""
        if self._gather_t is None:
            flat = np.nonzero(self.valid.reshape(-1))[0]
            cols = self.cols.reshape(-1)[flat]
            order = np.argsort(cols, kind="stable")
            slots, width = _slot_table(cols[order], self.shape[1])
            table = np.full(self.shape[1] * width, self.data.numel(),
                            np.int64)       # pads read an appended zero
            table[slots] = flat[order]
            self._gather_t = torch.from_numpy(table.reshape(
                self.shape[1], width)).to(self.device)
        vals = self._values()
        contrib = (vals[:, :, None] * (x[:, None] if x.ndim == 1
                                       else x)[:, None, :])
        contrib = contrib.reshape(-1, contrib.shape[-1])
        contrib = torch.cat([contrib, contrib.new_zeros(1, contrib.shape[1])])
        y = contrib[self._gather_t].sum(dim=1)
        return y[:, 0] if x.ndim == 1 else y

    @property
    def nnz(self) -> int:
        return int(self.valid.sum())

    @property
    def density(self) -> float:
        return self.nnz / (self.shape[0] * self.shape[1])

    def __repr__(self):
        return (f"ELL(shape={self.shape}, width={self.cols.shape[1]}, "
                f"nnz={self.nnz}, dtype={_dtype_name(self.data.dtype)})")
