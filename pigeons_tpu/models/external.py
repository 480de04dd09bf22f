"""External targets: host-callback bridge and lazy construction.

``ExternalTarget`` is the analogue of the reference's ``StreamTarget``
protocol (``src/targets/StreamTarget.jl``: one worker process per replica
speaking ``log_potential(beta)``/``call_sampler!`` over stdin/stdout, used for
Blang/TreePPL models). A per-replica text protocol defeats vectorization on
an accelerator, so the bridge is a BATCHED host callback instead: the user supplies a
host function evaluating the log density for a whole ``[batch, dim]`` block
at once (e.g. fanning out to a process pool); ``jax.pure_callback`` with
``vmap_method='expand_dims'`` splices it into the traced kernels. This is an
explicitly slow compatibility path — the device round-trips once per
evaluation — documented as such (SURVEY §7.4).

``LazyTarget`` defers target construction to each process for targets holding
non-picklable state (reference ``src/targets/LazyTarget.jl``): checkpoint/
ChildProcess serialization stores only the flag; each process instantiates
the real target on first use and caches it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .target import Reference, StandardNormalReference, Target


class ExternalTarget(Target):
    host_evaluated = True

    def __init__(
        self,
        batch_log_density: Callable[[np.ndarray], np.ndarray],
        dim: int,
        reference: Optional[Reference] = None,
    ):
        """``batch_log_density``: host function [batch, dim] -> [batch] float32."""
        self._host_fn = batch_log_density
        self.dim = dim
        self._reference = reference

    def log_density(self, x):
        def host(xb):  # [B, dim]; B == 1 for an unbatched call
            return np.asarray(self._host_fn(np.asarray(xb)), dtype=np.float32)

        return jax.pure_callback(
            host,
            jax.ShapeDtypeStruct((), jnp.float32),
            x,
            vmap_method="expand_dims",
        )

    def default_reference(self) -> Reference:
        if self._reference is not None:
            return self._reference
        return StandardNormalReference(self.dim).as_reference()


# ---------------------------------------------------------------------------


_lazy_cache: dict = {}


def instantiate_target(flag) -> Target:
    """Override/register per flag (reference ``instantiate_target``)."""
    raise NotImplementedError(
        "register a constructor with register_lazy_target(flag, fn)"
    )


_lazy_constructors: dict = {}


def register_lazy_target(flag: Any, constructor: Callable[[], Target]) -> None:
    _lazy_constructors[flag] = constructor


@dataclass(frozen=True)
class LazyTarget(Target):
    """Wraps a picklable flag; the target itself is built lazily per process
    (reference ``LazyTarget.jl:17-47``)."""

    flag: Any

    def _resolved(self) -> Target:
        if self.flag not in _lazy_cache:
            if self.flag in _lazy_constructors:
                _lazy_cache[self.flag] = _lazy_constructors[self.flag]()
            else:
                _lazy_cache[self.flag] = instantiate_target(self.flag)
        return _lazy_cache[self.flag]

    @property
    def dim(self):
        return self._resolved().dim

    @property
    def host_evaluated(self):
        return getattr(self._resolved(), "host_evaluated", False)

    def log_density(self, x):
        return self._resolved().log_density(x)

    def default_reference(self):
        return self._resolved().default_reference()

    def default_explorer(self):
        return self._resolved().default_explorer()

    def create_path(self, reference):
        return self._resolved().create_path(reference)

    def initialization(self, key):
        return self._resolved().initialization(key)

    def __getstate__(self):
        return {"flag": self.flag}

    def __setstate__(self, state):
        object.__setattr__(self, "flag", state["flag"])
