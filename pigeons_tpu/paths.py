"""Annealing paths: continuums of distributions indexed by beta in [0, 1].

Design note: the reference represents a discretized path as a vector
of callable log-potential closures dispatched per replica
(``src/schedules/discretize.jl``, ``src/paths/InterpolatedLogPotential.jl``).
Here a path is a single traced function ``log_density(x, beta)`` evaluated
under ``vmap`` over the whole replica batch with a per-replica beta vector —
one fused XLA computation for all chains instead of N dynamic dispatches.

Reference semantics:
  * linear interpolation (1-beta) * ref(x) + beta * target(x) with endpoint
    short-circuiting (``src/paths/InterpolatingPath.jl:3-27``);
  * toy scaled-precision normal path with analytic cumulative barrier and
    log-normalization oracles (``src/paths/ScaledPrecisionNormalPath.jl``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp


def _guarded_mul(w, v):
    """w * v with the convention 0 * (-inf) = 0.

    Reproduces the endpoint short-circuit of the reference interpolator
    (``InterpolatedLogPotential.jl:5-17``): at beta = 0 the target term must
    not pollute the result even if target(x) = -inf (outside support), and
    symmetrically at beta = 1.
    """
    return jnp.where(w == 0.0, jnp.zeros_like(v), w * v)


@dataclass(frozen=True)
class InterpolatingPath:
    """Linear path between a reference and a target log density.

    ``ref_log_density`` / ``target_log_density``: traced callables x -> scalar.
    ``sample_reference``: optional key -> x iid sampler for the reference
    (enables the reference-chain regeneration moves that drive tempered
    restarts, reference ``src/targets/target.jl:50-63``).
    """

    ref_log_density: Callable
    target_log_density: Callable
    sample_reference: Optional[Callable] = None
    # optional coordinate-wise decompositions ``(v, c) -> scalar`` with
    # ``log_density(x) == sum_c coord(x[c], c)``: when both endpoints provide
    # one, coordinate-wise explorers (the Pallas slice sampler) evaluate
    # single-coordinate proposals as O(1) density DELTAS instead of full
    # O(dim) recomputations — a capability the reference's per-closure design
    # cannot express (its SliceSampler re-evaluates the full density per
    # proposal, ``src/explorers/SliceSampler.jl:144-186``)
    ref_coord_log_density: Optional[Callable] = None
    target_coord_log_density: Optional[Callable] = None

    def log_density(self, x, beta):
        lref = self.ref_log_density(x)
        ltgt = self.target_log_density(x)
        return _guarded_mul(1.0 - beta, lref) + _guarded_mul(beta, ltgt)

    @property
    def has_iid_reference(self) -> bool:
        return self.sample_reference is not None

    @property
    def has_coordwise(self) -> bool:
        return (
            self.ref_coord_log_density is not None
            and self.target_coord_log_density is not None
        )

    def coord_log_density(self, v, c, beta):
        """Contribution of coordinate ``c`` holding value ``v`` at ``beta``."""
        lref = self.ref_coord_log_density(v, c)
        ltgt = self.target_coord_log_density(v, c)
        return _guarded_mul(1.0 - beta, lref) + _guarded_mul(beta, ltgt)


@dataclass(frozen=True)
class ScaledPrecisionNormalPath:
    """Toy MVN path: N(0, I/prec(beta)) with prec(beta) linear from
    ``precision0`` to ``precision1`` (Syed et al. 2021 section I.4.1).

    Every beta is iid-sampleable, and the cumulative barrier and log
    normalization are known in closed form — the main statistical test oracle
    (reference ``src/paths/ScaledPrecisionNormalPath.jl``).
    """

    precision0: float
    precision1: float
    dim: int

    def precision(self, beta):
        return (1.0 - beta) * self.precision0 + beta * self.precision1

    def log_density(self, x, beta):
        return -0.5 * self.precision(beta) * jnp.sum(x * x)

    has_coordwise = True

    def coord_log_density(self, v, c, beta):
        del c  # isotropic: every coordinate contributes -prec(beta) v^2 / 2
        return -0.5 * self.precision(beta) * v * v

    def sample_at(self, key, beta):
        sd = jax.lax.rsqrt(self.precision(beta))
        return sd * jax.random.normal(key, (self.dim,))

    def sample_reference(self, key):
        return self.sample_at(key, 0.0)

    @property
    def has_iid_reference(self) -> bool:
        return True

    # ---- analytic oracles (host-side, float64) ----

    def analytic_cumulative_barrier(self, beta):
        """Predescu et al. 2003 closed form
        (reference ``ScaledPrecisionNormalPath.jl:56-64``)."""
        import numpy as np

        beta = np.asarray(beta, dtype=np.float64)
        log_b = (
            math.lgamma(self.dim / 2.0) * 2.0 - math.lgamma(self.dim)
        )  # log Beta(d/2, d/2)
        b = math.exp(log_b)
        sigma0 = 1.0 / math.sqrt(self.precision0)
        sigmab = 1.0 / np.sqrt(
            (1.0 - beta) * self.precision0 + beta * self.precision1
        )
        return 2.0 ** (2.0 - self.dim) / b * np.log(sigma0 / sigmab)

    def analytic_lognormalization(self):
        """log(Z_target / Z_ref); Z propto prec^{-d/2}
        (reference ``ScaledPrecisionNormalPath.jl:66-70``)."""
        return 0.5 * self.dim * (math.log(self.precision0) - math.log(self.precision1))


def toy_mvn_path(dim: int) -> ScaledPrecisionNormalPath:
    """Reference ``ScaledPrecisionNormalPath(dim) = (1.0, 10.0, dim)``."""
    return ScaledPrecisionNormalPath(1.0, 10.0, dim)
