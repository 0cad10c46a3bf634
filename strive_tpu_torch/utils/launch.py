"""Shared pieces of the ctypes kernel wrappers.

:class:`Library` binds the plain C entry points of one ``csrc/<name>.cu``
(built at the first launch, never at import) and raises ``KernelError``
when a launch returns a CUDA error; :func:`check` is the input check every
wrapper runs before it launches; :func:`is_device_fault` tells such an
error, or one of CUDA itself, from other runtime errors.
"""

from __future__ import annotations

import ctypes
import re

import torch

from . import build
from .build import KernelError

# what torch's own CUDA, cuDNN and cuBLAS failures say
_CUDA_MESSAGE = re.compile(r"CUDA error|cuDNN error|"
                           r"CUBLAS_STATUS|CUDA out of memory")

PTR = ctypes.c_void_p
INT = ctypes.c_int


def check(name, t, dtypes, ndim, device, last=None):
    """Raise unless ``t`` is a contiguous CUDA tensor on ``device`` with one
    of ``dtypes`` (a dtype or a tuple), ``ndim`` dims and, if given, a last
    dim of ``last``."""
    dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                         f"got {t.dtype}")
    if t.dim() != ndim or (last is not None and t.shape[-1] != last):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class Library:
    """The entry points of ``csrc/<source>.cu``.

    :param signatures: {C function: ctypes argtypes}; each returns the
        launch's ``cudaError_t`` as an int
    """

    def __init__(self, source, signatures):
        self.source = source
        self._signatures = signatures
        self._lib = None

    def _load(self):
        if self._lib is None:
            lib = build.load(self.source)
            for fn, argtypes in self._signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.strive_cuda_error.argtypes = [INT]
            lib.strive_cuda_error.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, fn, *args):
        """Call the C entry point ``fn``; raise if the launch failed."""
        lib = self._load()
        err = getattr(lib, fn)(*args)
        if err != 0:
            msg = lib.strive_cuda_error(err).decode()
            raise KernelError(f"{fn} launch failed: cudaError {err} ({msg})")


def stream(device):
    """The current CUDA stream of ``device`` as the C entry points take it."""
    return torch.cuda.current_stream(device).cuda_stream


def is_device_fault(err):
    """True for an error of a kernel of this package or of its build, and
    for one of CUDA itself (torch's ``AcceleratorError``, a CUDA
    out-of-memory error, or a CUDA, cuDNN or cuBLAS failure)."""
    kinds = (KernelError, torch.cuda.OutOfMemoryError,
             getattr(torch, "AcceleratorError", KernelError))
    return isinstance(err, kinds) or bool(_CUDA_MESSAGE.search(str(err)))
