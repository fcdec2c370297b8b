"""CSR SDDMM: the Hopper kernel's wrapper, its plain torch version and its
launch count.

``out[p] = Σ_c G[major[p], c]·X[colind[p], c]`` for every stored slot
``p``, and 0 where ``major[p] == nrows`` (a padding slot): the gradient of
a CSR product with respect to its values (``dvals``), for SpMV (``k = 1``,
``g[row]·x[col]``) and SpMM alike. ``major`` is the per-slot row id of the
cached transpose plan (``TransposeStructure.major``).

The kernel (``spalinalg_tpu_torch/csrc/csr_sddmm.cu``) has no Pallas
counterpart: in the JAX package ``dvals`` is XLA code,
``spalinalg_tpu/ops/kernels/csr_route.py:1093`` (SpMV) and ``:1364``
(SpMM). It has two variants, chosen by :func:`csr_sddmm_variant` and
passed to the kernel by name: ``vector`` (16-byte row loads) where
``k·itemsize`` is a multiple of 16 and ``G`` and ``X`` start on a 16-byte
boundary, ``scalar`` otherwise.

:func:`csr_sddmm` is the wrapper. For CUDA tensors it launches the kernel
or raises; for CPU tensors it runs :func:`csr_sddmm_plain`.

>>> major = torch.tensor([0, 0, 1, 2], dtype=torch.int32)   # slot 3: padding
>>> colind = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
>>> G = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
>>> X = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
>>> csr_sddmm(major, colind, G, X, 2)
tensor([1., 2., 4., 0.])
"""

from __future__ import annotations

import torch

from ...dtypes import INDEX_DTYPE, acc_dtype
from ...errors import DTypeError, ShapeError

__all__ = ["LAUNCHES", "VARIANT_LAUNCHES", "csr_sddmm", "csr_sddmm_plain",
           "csr_sddmm_variant"]

# Kernel launches per instantiation and per variant: plain integers,
# advanced only where the wrapper launches the kernel.
LAUNCHES = {"float32": 0, "float64": 0}
VARIANT_LAUNCHES = {"scalar": 0, "vector": 0}

_VARIANT_CODE = {"scalar": 0, "vector": 1}

_ENTRY = {torch.float32: ("spal_csr_sddmm_f32", "float32"),
          torch.float64: ("spal_csr_sddmm_f64", "float64")}

# Elements per gathered temporary of the plain version: at k = 64 and 17M
# entries an unchunked gather would take 8.9 GB per array in float64.
_CHUNK = 1 << 26


def csr_sddmm_variant(G, X) -> str:
    """The variant of ``csrc/csr_sddmm.cu`` for 2-D ``G`` and ``X`` as the
    kernel takes them (accumulation type, contiguous): ``"vector"`` when a
    row is a whole number of 16-byte vectors (``k·itemsize % 16 == 0``)
    and both start on a 16-byte boundary, else ``"scalar"``.

    >>> csr_sddmm_variant(torch.zeros(3, 64), torch.zeros(5, 64))
    'vector'
    >>> csr_sddmm_variant(torch.zeros(3, 1), torch.zeros(5, 1))
    'scalar'
    """
    if G.element_size() * G.shape[1] % 16 == 0 \
            and G.data_ptr() % 16 == 0 and X.data_ptr() % 16 == 0:
        return "vector"
    return "scalar"


def csr_sddmm_plain(major, colind, G, X, nrows: int) -> torch.Tensor:
    """Plain torch SDDMM: the gathered rows multiplied and summed, in
    chunks of slots so that no temporary passes ``_CHUNK`` elements. 1-D
    ``G`` and ``X`` are the ``k = 1`` case. Padding slots give 0."""
    if G.ndim == 1:
        G, X = G[:, None], X[:, None]
    G_ext = torch.cat([G, G.new_zeros(1, G.shape[1])])
    step = max(1, _CHUNK // max(1, X.shape[1]))
    parts = [(G_ext[r] * X[c]).sum(1)
             for r, c in zip(major.split(step), colind.split(step))]
    if not parts:
        return G.new_zeros(0)
    return torch.cat(parts)


def csr_sddmm(major, colind, G, X, nrows: int) -> torch.Tensor:
    """``out[p] = Σ_c G[major[p], c]·X[colind[p], c]`` (0 for padding
    slots): the kernel on CUDA tensors, the plain version on CPU tensors.
    ``G`` (``nrows`` or ``(nrows, k)``) and ``X`` (``ncols`` or ``(ncols,
    k)``) are promoted to the accumulation dtype and made contiguous; the
    result is in that dtype."""
    acc = acc_dtype(G.dtype, X.dtype)
    G = G.to(acc).contiguous()
    X = X.to(acc).contiguous()
    devices = {t.device for t in (major, colind, G, X)}
    if len(devices) != 1:
        raise ValueError(f"csr_sddmm operands on several devices: {devices}")
    if major.dtype != INDEX_DTYPE or colind.dtype != INDEX_DTYPE:
        raise DTypeError(
            f"indices must be {INDEX_DTYPE}, got {major.dtype} and "
            f"{colind.dtype}")
    if (major.ndim != 1 or major.shape != colind.shape or G.ndim != X.ndim
            or G.ndim not in (1, 2) or G.shape[0] != nrows
            or G.shape[1:] != X.shape[1:]):
        raise ShapeError(
            f"csr_sddmm shapes: major {tuple(major.shape)}, colind "
            f"{tuple(colind.shape)}, G {tuple(G.shape)}, X "
            f"{tuple(X.shape)}, nrows {nrows}")
    device = X.device
    if device.type == "cpu":
        return csr_sddmm_plain(major, colind, G, X, nrows)
    if device.type != "cuda":
        raise ValueError(f"no csr_sddmm kernel for device {device}")
    nse = colind.numel()
    out = torch.empty(nse, dtype=acc, device=device)
    if G.ndim == 1:
        G, X = G[:, None], X[:, None]
    k = G.shape[1]
    if nse == 0:
        return out
    if k == 0:
        return out.zero_()
    from ._build import launch

    name, key = _ENTRY[acc]
    variant = csr_sddmm_variant(G, X)
    major, colind = major.contiguous(), colind.contiguous()
    with torch.cuda.device(device):
        launch(name, major.data_ptr(), colind.data_ptr(), G.data_ptr(),
               X.data_ptr(), out.data_ptr(), nse, nrows, k,
               _VARIANT_CODE[variant],
               torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[key] += 1
    VARIANT_LAUNCHES[variant] += 1
    return out
