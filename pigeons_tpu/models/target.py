"""Target interface: what a model must provide to be tempered.

Reference interface (``src/targets/target.jl:4-99``): ``initialization``,
``default_explorer`` (slice sampler), ``default_reference``, ``sample_iid!``,
``create_path`` (default: linear interpolation reference -> target). The
batched contract replaces dynamic dispatch with traced callables:

  * ``log_density(x)``: traced target log density for one state vector;
  * ``default_reference()``: a :class:`Reference` (log density + iid sampler);
  * ``create_path(reference)``: object with ``log_density(x, beta)`` (and
    optionally ``sample_at(key, beta)`` for iid-at-any-beta toy paths);
  * ``initialization(key)``: one initial state (vmapped over replicas).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..paths import InterpolatingPath


@dataclass(frozen=True)
class Reference:
    """A reference distribution: unnormalized log density + iid sampler."""

    log_density: Callable  # x -> scalar
    sample_iid: Optional[Callable] = None  # key -> x


class Target:
    dim: int

    def log_density(self, x):
        raise NotImplementedError

    def default_reference(self) -> Reference:
        raise NotImplementedError

    def default_explorer(self):
        """Slice sampler with coordinate types auto-detected from the target:
        a target exposing ``integer_mask`` / ``binary_mask`` properties gets
        its ordinal coordinates handled with the reference's integer
        conventions and its Bool coordinates routed to the in-sampler exact
        Gibbs draw (reference ``SliceSampler.jl:65-86,136-142`` special-cases
        both in the default explorer — no manual ``Compose`` needed)."""
        from ..ops import SliceSampler

        kw = {}
        im = getattr(self, "integer_mask", None)
        bm = getattr(self, "binary_mask", None)
        if im is not None:
            kw["integer_mask"] = im
        if bm is not None:
            kw["binary_mask"] = bm
        return SliceSampler(**kw)

    def create_path(self, reference: Reference):
        return InterpolatingPath(
            ref_log_density=reference.log_density,
            target_log_density=self.log_density,
            sample_reference=reference.sample_iid,
        )

    def initialization(self, key):
        ref = self.default_reference()
        if ref.sample_iid is None:
            return jnp.zeros((self.dim,), jnp.float32)
        return ref.sample_iid(key)


@dataclass(frozen=True)
class CustomPath:
    """Arbitrary annealing path: any ``(x, beta) -> scalar`` tempering scheme,
    not restricted to two-endpoint linear interpolation. This is the analogue
    of implementing the reference's ``path``/``interpolate`` informal
    interface directly (``src/paths/path.jl:7-13``) — e.g. the JuliaBUGS
    extension tempers through a model temperature parameter,
    ``logprior + beta * loglikelihood`` (``ext/PigeonsJuliaBUGSExt/
    interface.jl:61-82``), rather than interpolating two endpoints.

    ``sample_reference``: optional ``key -> x`` iid sampler at beta = 0
    (enables reference-chain regeneration); ``sample_at``: optional
    ``(key, beta) -> x`` iid sampler at every beta (enables ToyExplorer and
    iid toy paths)."""

    log_density_fn: Callable  # (x, beta) -> scalar
    sample_reference: Optional[Callable] = None  # key -> x
    sample_at: Optional[Callable] = None  # (key, beta) -> x

    def log_density(self, x, beta):
        return self.log_density_fn(x, beta)

    @property
    def has_iid_reference(self) -> bool:
        return self.sample_reference is not None


class CustomPathTarget(Target):
    """A target defined directly by its annealing path (reference targets
    whose ``create_path`` does not return an ``InterpolatingPath``)."""

    def __init__(self, path: CustomPath, dim: int):
        self.path = path
        self.dim = dim

    def log_density(self, x):
        import jax.numpy as _jnp

        return self.path.log_density(x, _jnp.float32(1.0))

    def default_reference(self) -> Reference:
        return Reference(
            log_density=lambda x: self.path.log_density(x, jnp.float32(0.0)),
            sample_iid=self.path.sample_reference,
        )

    def create_path(self, reference):
        del reference
        return self.path

    def initialization(self, key):
        if self.path.sample_reference is not None:
            return self.path.sample_reference(key)
        return jnp.zeros((self.dim,), jnp.float32)


@dataclass(frozen=True)
class StandardNormalReference:
    """N(0, sigma^2 I) reference, the generic default."""

    dim: int
    sigma: float = 1.0

    def as_reference(self) -> Reference:
        sigma = self.sigma
        dim = self.dim

        def log_density(x):
            return -0.5 * jnp.sum((x / sigma) ** 2)

        def sample_iid(key):
            return sigma * jax.random.normal(key, (dim,))

        return Reference(log_density=log_density, sample_iid=sample_iid)
