"""Backend names and the block / padding policy (port of
:mod:`repro.core.blocking`, the parts the ported paths need).

``block_size`` is clamped to ``n`` and, when the clamped block does not
divide ``n``, the operands are padded up to the next block multiple.  The
pad is exact: the padded system is ``[[A, 0], [0, I]]`` with a zero-padded
right-hand side, so the leading ``n`` solution components are unchanged.
Block-Jacobi uses it to cut any ``n`` into equal diagonal blocks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BACKENDS = ("ref", "cuda")


def check_backend(backend: str, mesh=None) -> None:
    """Validation shared by the entry points: a known name, and the
    hand-written kernels are single-device."""
    check_backend_name(backend)
    if backend == "cuda" and mesh is not None:
        raise ValueError("backend='cuda' is single-device only; drop mesh= "
                         "or use backend='ref'")


def check_backend_name(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")


def effective_backend(backend: str, dtype) -> str:
    """The hand-written kernels take float32 only; every other dtype runs
    the plain tensor path on the same device (float64 keeps float64
    accuracy) — the reference's rule for its Pallas backend."""
    return "ref" if backend == "cuda" and dtype != torch.float32 else backend


def choose_block(n: int, block_size: int) -> int:
    if block_size < 1:
        raise ValueError(f"block_size={block_size} must be >= 1")
    return min(block_size, n)


def padded_size(n: int, nb: int) -> int:
    return -(-n // nb) * nb


def pad_system(a: torch.Tensor, block_size: int
               ) -> tuple[torch.Tensor, int, int]:
    """Return ``(a_padded, nb, n_padded)`` with an identity pad block."""
    n = a.shape[-1]
    if a.ndim != 2 or a.shape[0] != n:
        raise ValueError(f"expected a square (n, n) matrix, got "
                         f"{tuple(a.shape)}")
    nb = choose_block(n, block_size)
    n_pad = padded_size(n, nb)
    if n_pad != n:
        pad = n_pad - n
        a = F.pad(a, (0, pad, 0, pad))
        a[n:, n:] = torch.eye(pad, dtype=a.dtype, device=a.device)
    return a, nb, n_pad


def working_copy(a: torch.Tensor, block_size: int
                 ) -> tuple[torch.Tensor, int, int]:
    """:func:`pad_system` as a fresh copy that a factorization may write in
    place (``pad_system`` returns ``a`` itself when it needs no pad)."""
    n0 = a.shape[-1]
    a, nb, n = pad_system(a, block_size)
    return (a.clone() if n == n0 else a), nb, n


def pad_rect(a: torch.Tensor, block_size: int
             ) -> tuple[torch.Tensor, int, int, int]:
    """Rectangular pad policy of the least-squares (QR) path: pad rows and
    columns independently up to block multiples.  Returns ``(a_padded, nb,
    m_padded, n_padded)``; ``a`` itself when it needs no pad.

    The padded matrix is ``[[A, 0], [0, E]]`` with ``E = [I; 0]``: one unit
    column per pad column, each on its own pad row (rows are padded by
    whole blocks until they can host them).  It keeps full column rank, its
    R factor is ``[[R, 0], [0, ±I]]``, and a zero-padded right-hand side
    solves to exact zeros in the pad components.  Raises on a non-2-D
    input, ``block_size < 1`` and an underdetermined ``m < n``, with the
    reference's messages.
    """
    if a.ndim != 2:
        raise ValueError(f"expected a 2-D (m, n) matrix, got "
                         f"{tuple(a.shape)}")
    m, n = a.shape
    if m < n:
        raise ValueError(
            f"underdetermined system {tuple(a.shape)} (m < n): the QR/LSQR "
            "path solves least squares for m >= n; solve the transposed "
            "system for the minimum-norm solution")
    nb = choose_block(n, block_size)
    n_pad = padded_size(n, nb)
    m_pad = padded_size(m, nb)
    while m_pad - m < n_pad - n:
        m_pad += nb
    if (m_pad, n_pad) != (m, n):
        a = F.pad(a, (0, n_pad - n, 0, m_pad - m))
        pad = torch.arange(n_pad - n, device=a.device)
        a[m + pad, n + pad] = 1
    return a, nb, m_pad, n_pad


def pad_rhs(b: torch.Tensor, n_padded: int) -> torch.Tensor:
    """Zero-pad the leading axis of a right-hand side up to ``n_padded``."""
    pad = n_padded - b.shape[0]
    if pad < 0:
        raise ValueError(f"rhs has {b.shape[0]} rows; factor only covers "
                         f"{n_padded}")
    if pad:
        b = F.pad(b, (0, 0) * (b.ndim - 1) + (0, pad))
    return b
