"""Carry a solver's state or a model's weights across from numpy arrays.

For a solver, the system, the preconditioner's state and a direct method's
factors are what weights are to a model.  These functions take them as
numpy arrays — for example the ``data`` of a :mod:`repro` preconditioner,
the factors of :func:`repro.core.lu.lu_factor`, the arrays of a
:mod:`repro.sparse` ``BSR`` / ``ELL`` or a model's param pytree, converted
with ``numpy.asarray`` — so that both packages apply the same operator or
run the same model.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import precond as _precond
from repro_torch.core import qr as _qr
from repro_torch.models import layers as _layers
from repro_torch.models import transformer as _transformer
from repro_torch.sparse import formats as _formats


def _tensor(v, dev):
    return torch.from_numpy(np.array(v, order="C")).to(dev)   # a copy


def precond_from_numpy(kind: str, data, *, device=None
                       ) -> _precond.Preconditioner:
    """The port's :class:`~repro_torch.core.precond.Preconditioner` from a
    named preconditioner's arrays: ``(dinv,)`` for ``"jacobi"``;
    ``(lu, piv)`` for ``"block_jacobi"``, with ``lu`` (k, nb, nb) and
    ``piv`` (k, nb) as ``jax.scipy.linalg.lu_factor`` returns them.

    Those pivots are 0-based; ``torch.linalg.lu_solve`` takes 1-based
    LAPACK pivots, so they are shifted by one here.
    """
    dev = _device.resolve(device)
    if kind == "jacobi":
        (dinv,) = data
        return _precond.from_data(kind, (_tensor(dinv, dev),))
    if kind == "block_jacobi":
        lu, piv = data
        piv1 = _tensor(np.asarray(piv).astype(np.int32) + 1, dev)
        return _precond.from_data(kind, (_tensor(lu, dev), piv1))
    raise ValueError(f"unknown preconditioner {kind!r}; expected 'jacobi' "
                     "or 'block_jacobi'")


def system_from_numpy(a, b, x0=None, *, device=None):
    """``(a, b, x0)`` as contiguous tensors on ``device`` (``None`` →
    ``"cuda"``); ``x0`` stays ``None`` when not given."""
    dev = _device.resolve(device)
    return (_tensor(a, dev), _tensor(b, dev),
            None if x0 is None else _tensor(x0, dev))


def lu_state_from_numpy(lu, perm, *, device=None):
    """A ``method="lu"`` factor state ``(LU_packed, perm)`` from the arrays
    of :func:`repro.core.lu.lu_factor` (``perm`` with A[perm] = L U), for
    :func:`repro_torch.core.lu.lu_apply`."""
    dev = _device.resolve(device)
    return (_tensor(lu, dev),
            _tensor(np.asarray(perm).astype(np.int64), dev))


def cholesky_state_from_numpy(l, *, device=None):
    """A ``method="cholesky"`` factor state ``(L,)`` from the array of
    :func:`repro.core.cholesky.cholesky_factor`, for
    :func:`repro_torch.core.cholesky.cholesky_apply`."""
    return (_tensor(l, _device.resolve(device)),)


def qr_state_from_numpy(qr, taus, tmats, m0: int, n0: int, nb: int, *,
                        device=None) -> _qr.QrState:
    """A ``method="qr"`` factor state from the arrays of a
    :class:`repro.core.qr.QrState` (packed ``qr``, ``taus``, ``tmats``) and
    its logical shape ``m0``, ``n0`` and block ``nb``, for
    :func:`repro_torch.core.qr.qr_apply`."""
    dev = _device.resolve(device)
    return _qr.QrState(_tensor(qr, dev), _tensor(taus, dev),
                       _tensor(tmats, dev), m0=int(m0), n0=int(n0),
                       nb=int(nb))


def bsr_from_numpy(data, indices, indptr, shape, nb, *, device=None
                   ) -> _formats.BSR:
    """The port's :class:`~repro_torch.sparse.formats.BSR` from a BSR's
    arrays: bricks ``data`` (nnzb, nb, nb), block columns ``indices``,
    block-row offsets ``indptr``, the logical ``shape`` and brick size
    ``nb`` (a :mod:`repro.sparse` BSR's ``data``, ``indices``, ``indptr``,
    ``shape`` and ``nb``)."""
    dev = _device.resolve(device)
    return _formats.BSR(_tensor(data, dev), np.asarray(indices),
                        np.asarray(indptr), shape, nb, device=dev)


def ell_from_numpy(data, cols, valid, shape, *, device=None) -> _formats.ELL:
    """The port's :class:`~repro_torch.sparse.formats.ELL` from an ELL's
    arrays: values ``data`` (n, width), column table ``cols`` and slot mask
    ``valid`` of the same shape, and the logical ``shape``."""
    dev = _device.resolve(device)
    return _formats.ELL(_tensor(data, dev), np.asarray(cols),
                        np.asarray(valid), shape, device=dev)


def _weight(a, dtype: torch.dtype, dev) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as ``numpy.asarray`` gives
    them from a JAX array) as a ``dtype`` tensor on ``dev``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # no numpy type torch reads: the bits
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))
    return t.to(device=dev, dtype=dtype)


def _group(tree: dict, dtype, dev, index=None) -> _layers.Params:
    return _layers.Params({
        name: (_group(item, dtype, dev, index) if isinstance(item, dict)
               else _weight(item if index is None else np.asarray(item)[index],
                            dtype, dev))
        for name, item in tree.items()})


def transformer_params_from_numpy(params: dict, cfg, *, device=None
                                  ) -> _transformer.Transformer:
    """The port's dense model from the reference's param pytree for
    ``cfg`` (``{"embed", "layers", "final_norm"}``, every leaf a numpy
    array, the layers stacked on a leading axis as the reference's
    ``init_params`` makes them), in ``cfg``'s param dtype on ``device``
    (``None``: the GPU)."""
    dev = _device.resolve(device)
    dtype = _layers.dtype_of(cfg)
    layers = [_group(params["layers"], dtype, dev, i)
              for i in range(cfg.num_layers)]
    return _transformer.Transformer(
        _group(params["embed"], dtype, dev), layers,
        _group(params["final_norm"], dtype, dev))
