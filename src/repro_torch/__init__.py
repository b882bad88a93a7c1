"""CUPLSS on PyTorch: the port of :mod:`repro` to NVIDIA Hopper GPUs.

The package mirrors ``repro``'s module paths (``core/``, ``kernels/``,
``resilience/``, ``launch/``), so each module's counterpart is found under
the same name.  Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path is a hand-written Hopper kernel under ``kernels/csrc/``, built
with ``nvcc`` the first time a CUDA tensor reaches it (importing the
package builds nothing).

Entry points run on the GPU (``device=None`` means ``"cuda"``) and raise
when no GPU is present; ``device="cpu"`` runs the plain tensor path on the
CPU, which is what the tests use.

    >>> from repro_torch.core import api
    >>> x = api.solve(a, b, method="cg", backend="cuda")
"""
