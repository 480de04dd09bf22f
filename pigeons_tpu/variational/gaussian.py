"""Mean-field Gaussian variational reference.

Reference semantics (``src/variational/GaussianReference.jl``): a diagonal
Gaussian fit by MOMENT MATCHING (mean/std taken from the online statistics of
the target-chain samples in the sampling parameterization — no gradient-based
ELBO); activates at rounds >= ``first_tuning_round`` (default 6); provides a
log density, an iid sampler, and an analytic gradient (free here via
``jax.grad``).

Design: the variational parameters are plain arrays threaded into
the round kernel as ``ref_params``, so refitting between rounds does NOT
recompile anything — the same traced program reads new parameter values. An
``active`` flag (0/1 array) blends the fixed reference and the variational one
inside the traced path, mirroring the reference's between-round path swap
(``variational.jl:28-39``).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class GaussianReference:
    first_tuning_round: int = 6

    def init_params(self, dim: int):
        return {
            "mean": jnp.zeros((dim,), jnp.float32),
            "std": jnp.ones((dim,), jnp.float32),
            "active": jnp.zeros((), jnp.float32),
        }

    def active(self, round_idx: int) -> bool:
        """Reference ``GaussianReference.jl:17-20``."""
        return round_idx >= self.first_tuning_round

    def fit(self, params, reduced, round_idx: int):
        """Moment-matching update from the online recorder of target-chain
        samples (reference ``update_reference!``, ``GaussianReference.jl:22-27``)."""
        if not self.active(round_idx):
            return params
        mean = np.asarray(reduced.online_mean[:-1], dtype=np.float32)
        std = np.sqrt(np.maximum(np.asarray(reduced.online_var[:-1]), 1e-12)).astype(
            np.float32
        )
        return {
            "mean": jnp.asarray(mean),
            "std": jnp.asarray(std),
            "active": jnp.ones((), jnp.float32),
        }

    @staticmethod
    def log_density(x, params):
        mean, std = params["mean"], params["std"]
        return jnp.sum(
            -0.5 * jnp.log(2.0 * jnp.pi * std * std) - 0.5 * ((x - mean) / std) ** 2
        )

    # -- coordinate-wise decomposition (mean-field => additively separable) --
    # lets the banded Pallas slice kernel run under a variational reference:
    # the per-coordinate mean/std ride to the kernel as banded blocks
    # (coord_param_arrays), never gathered by a traced index

    @staticmethod
    def coord_param_arrays(params):
        """Per-coordinate parameter vectors consumed by ``coord_log_density``."""
        return (params["mean"], params["std"])

    @staticmethod
    def coord_log_density(v, mean_c, std_c):
        """Coordinate ``c``'s contribution, given its own mean/std."""
        return (
            -0.5 * jnp.log(2.0 * jnp.pi * std_c * std_c)
            - 0.5 * ((v - mean_c) / std_c) ** 2
        )

    @staticmethod
    def sample(key, params):
        mean, std = params["mean"], params["std"]
        return mean + std * jax.random.normal(key, mean.shape, mean.dtype)
