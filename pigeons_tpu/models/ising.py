"""2-D Ising model: the discrete-state flagship example.

Reference (``examples/ising.jl``): p(state) proportional to exp(-beta_ising H),
H = -sum over neighbour pairs of spin products, spins in {-1, +1}; the
annealing reference is iid Bernoulli(1/2) (iid-sampleable, giving tempered
restarts), explored with exact binary Gibbs updates.

Batched form: the state is a float {0,1} vector of length L^2; the pair sum is
one vectorized roll-and-multiply (periodic boundary), evaluated for the whole
chain ladder under vmap.
"""

from __future__ import annotations

from dataclasses import dataclass

import itertools

import jax
import jax.numpy as jnp
import numpy as np

from .target import Reference, Target


@dataclass(frozen=True)
class IsingTarget(Target):
    beta_ising: float = 1.0
    base_length: int = 5

    @property
    def dim(self):
        return self.base_length * self.base_length

    def _pair_sum(self, x):
        s = (2.0 * x - 1.0).reshape(self.base_length, self.base_length)
        # periodic torus: each undirected neighbour pair counted once
        return jnp.sum(s * jnp.roll(s, 1, axis=0)) + jnp.sum(s * jnp.roll(s, 1, axis=1))

    def log_density(self, x):
        return self.beta_ising * self._pair_sum(x)

    def default_reference(self) -> Reference:
        d = self.dim
        return Reference(
            log_density=lambda x: jnp.zeros((), jnp.float32),  # iid Bern(1/2), const
            sample_iid=lambda key: jax.random.bernoulli(key, 0.5, (d,)).astype(
                jnp.float32
            ),
        )

    def default_explorer(self):
        from ..ops.binary_gibbs import BinaryGibbs

        return BinaryGibbs()

    def initialization(self, key):
        return self.default_reference().sample_iid(key)

    # ---- exact oracles by enumeration (tests; small L only) ----

    def enumerate_oracle(self):
        """Exact log Z (relative to the Bern(1/2) reference) and mean |M| by
        enumerating all 2^(L^2) states."""
        L = self.base_length
        n = L * L
        if n > 16:
            raise ValueError("enumeration only for tiny lattices")
        states = np.array(list(itertools.product([0.0, 1.0], repeat=n)), np.float32)
        lps = np.asarray(jax.vmap(self.log_density)(jnp.asarray(states)))
        lz = np.logaddexp.reduce(lps) - n * np.log(2.0)  # vs uniform reference
        w = np.exp(lps - lps.max())
        w /= w.sum()
        mag = np.abs((2.0 * states - 1.0).mean(axis=1))
        return float(lz), float((w * mag).sum())


def ising_target(beta_ising: float = 1.0, base_length: int = 5) -> IsingTarget:
    return IsingTarget(beta_ising, base_length)
