"""Native targets: models compiled to shared libraries, called via a C ABI.

Parity with the reference's BridgeStan extension
(``ext/PigeonsBridgeStanExt/interface.jl:120-183``): there, Stan models are
compiled to ``.so`` files and the log density / gradient are allocation-free
``ccall``s with errors mapped to ``-Inf``. Here a model is any shared library
exporting the ``ptn_`` C ABI below (C, C++, Fortran, or a Stan model wrapped
by a thin shim):

.. code-block:: c

    /* required */
    int    ptn_dim(void);
    double ptn_log_density(const double* x, int dim);
    /* optional: enables gradient explorers (AutoMALA default, as for Stan
       targets in the reference, ext/PigeonsBridgeStanExt/interface.jl:52) */
    double ptn_log_density_gradient(const double* x, int dim, double* grad);
    /* optional: batched fast path, row-major [batch, dim] */
    void   ptn_log_density_batch(const double* x, int batch, int dim,
                                 double* lp_out);

Device mapping: the library is evaluated on the HOST through a batched
``jax.pure_callback`` — one callback per vmapped batch, looping (or batch
entry point) on the host — and the gradient rides a ``jax.custom_vjp`` so the
traced kernels (`jax.grad`, AutoMALA leapfrogs) differentiate through it.
Like the stream bridge this is the documented slow compatibility path
(SURVEY §7.4); pure-JAX targets stay on-device.

Serialization matches the reference's custom Stan serializer
(``interface.jl:34-49``): only the library path pickles; each process
re-``dlopen``s on first use (checkpoint/ChildProcess safe).

An example C++ model and build recipe live in ``examples/native/``.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .target import Reference, StandardNormalReference, Target

_NEG_INF = float("-inf")


class _NativeLib:
    """ctypes binding of one ``ptn_`` library (cached per path per process)."""

    _cache: dict = {}

    def __new__(cls, path: str):
        path = os.path.abspath(path)
        if path not in cls._cache:
            self = super().__new__(cls)
            self._init(path)
            cls._cache[path] = self
        return cls._cache[path]

    def _init(self, path: str) -> None:
        self.path = path
        lib = ctypes.CDLL(path)
        lib.ptn_dim.restype = ctypes.c_int
        lib.ptn_dim.argtypes = []
        c_dbl_p = ctypes.POINTER(ctypes.c_double)
        lib.ptn_log_density.restype = ctypes.c_double
        lib.ptn_log_density.argtypes = [c_dbl_p, ctypes.c_int]
        self.lib = lib
        self.dim = int(lib.ptn_dim())
        self.has_gradient = hasattr(lib, "ptn_log_density_gradient")
        if self.has_gradient:
            lib.ptn_log_density_gradient.restype = ctypes.c_double
            lib.ptn_log_density_gradient.argtypes = [c_dbl_p, ctypes.c_int, c_dbl_p]
        self.has_batch = hasattr(lib, "ptn_log_density_batch")
        if self.has_batch:
            lib.ptn_log_density_batch.restype = None
            lib.ptn_log_density_batch.argtypes = [
                c_dbl_p, ctypes.c_int, ctypes.c_int, c_dbl_p,
            ]

    # all entry points guard non-finite results to -Inf, as the reference
    # maps Stan exceptions to -Inf (interface.jl:128-141)
    def log_density_batch(self, xb: np.ndarray) -> np.ndarray:
        xb = np.ascontiguousarray(xb, dtype=np.float64)
        b, d = xb.shape
        out = np.empty((b,), np.float64)
        ptr = xb.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if self.has_batch:
            self.lib.ptn_log_density_batch(
                ptr, b, d, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            )
        else:
            for i in range(b):
                row = xb[i]
                out[i] = self.lib.ptn_log_density(
                    row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), d
                )
        out[~np.isfinite(out)] = _NEG_INF
        return out

    def gradient_batch(self, xb: np.ndarray):
        xb = np.ascontiguousarray(xb, dtype=np.float64)
        b, d = xb.shape
        lps = np.empty((b,), np.float64)
        grads = np.empty((b, d), np.float64)
        for i in range(b):
            row = np.ascontiguousarray(xb[i])
            lps[i] = self.lib.ptn_log_density_gradient(
                row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                d,
                grads[i].ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
        bad = ~np.isfinite(lps)
        lps[bad] = _NEG_INF
        grads[bad] = 0.0
        return lps, grads


class NativeTarget(Target):
    """Temper a model compiled to a ``ptn_`` ABI shared library."""

    host_evaluated = True  # density runs on the host: PT places the kernels
    # on the CPU backend when the default backend lacks callback support

    def __init__(self, lib_path: str, reference: Optional[Reference] = None):
        self._lib_path = os.path.abspath(lib_path)
        self._reference = reference
        lib = _NativeLib(self._lib_path)
        self.dim = lib.dim
        self._build_log_density(lib.has_gradient)

    def _build_log_density(self, has_gradient: bool) -> None:
        path = self._lib_path

        def _lp_host(xb):
            x2 = np.asarray(xb, np.float64).reshape(-1, _NativeLib(path).dim)
            out = _NativeLib(path).log_density_batch(x2).astype(np.float32)
            return out.reshape(np.shape(xb)[:-1])

        def _lp_callback(x):
            return jax.pure_callback(
                _lp_host,
                jax.ShapeDtypeStruct(jnp.shape(x)[:-1], jnp.float32),
                x,
                vmap_method="expand_dims",
            )

        if not has_gradient:
            self._log_density = _lp_callback
            return

        def _grad_host(xb):
            x2 = np.asarray(xb, np.float64).reshape(-1, _NativeLib(path).dim)
            lps, grads = _NativeLib(path).gradient_batch(x2)
            return (
                lps.astype(np.float32).reshape(np.shape(xb)[:-1]),
                grads.astype(np.float32).reshape(np.shape(xb)),
            )

        @jax.custom_vjp
        def lp(x):
            return _lp_callback(x)

        def lp_fwd(x):
            l, g = jax.pure_callback(
                _grad_host,
                (
                    jax.ShapeDtypeStruct(jnp.shape(x)[:-1], jnp.float32),
                    jax.ShapeDtypeStruct(jnp.shape(x), jnp.float32),
                ),
                x,
                vmap_method="expand_dims",
            )
            return l, g

        def lp_bwd(g, ct):
            return (g * ct[..., None],)

        lp.defvjp(lp_fwd, lp_bwd)
        self._log_density = lp

    # -- Target interface ---------------------------------------------------
    def log_density(self, x):
        return self._log_density(x)

    def default_reference(self) -> Reference:
        if self._reference is not None:
            return self._reference
        return StandardNormalReference(self.dim).as_reference()

    def default_explorer(self):
        if _NativeLib(self._lib_path).has_gradient:
            from ..ops import AutoMALA

            return AutoMALA()
        return super().default_explorer()

    # -- serialization: path only, reload per process -----------------------
    def __getstate__(self):
        return {"_lib_path": self._lib_path, "_reference": self._reference}

    def __setstate__(self, state):
        self._lib_path = state["_lib_path"]
        self._reference = state["_reference"]
        lib = _NativeLib(self._lib_path)
        self.dim = lib.dim
        self._build_log_density(lib.has_gradient)


def compile_native_model(
    source: str, out_path: str, compiler: str = "g++", flags: tuple = ("-O3",)
) -> str:
    """Compile a C/C++ ``ptn_`` model source file to a shared library (the
    analogue of BridgeStan's model compilation step). Returns ``out_path``."""
    import subprocess

    cmd = [compiler, "-shared", "-fPIC", *flags, source, "-o", out_path, "-lm"]
    subprocess.run(cmd, check=True, capture_output=True)
    return out_path
