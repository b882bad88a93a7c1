"""Sparse linear-algebra subsystem of the port (mirrors :mod:`repro.sparse`):
formats (BSR / ELL), stencil problem generators, the sparse
LinearOperator engine (:mod:`repro_torch.sparse.operator`) and matrix-free
preconditioners (:mod:`repro_torch.sparse.precond`).  ``api.solve`` on a
:class:`BSR` / :class:`ELL` matrix runs every registered Krylov method;
``backend="cuda"`` runs its matvecs through the hand-written BSR SpMV
kernel."""
from repro_torch.sparse.formats import BSR, ELL, SparseMatrix  # noqa: F401
from repro_torch.sparse import problems  # noqa: F401
