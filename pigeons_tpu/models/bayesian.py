"""BayesianModel: the model frontend — named, constrained parameters with
priors plus a likelihood, compiled to an unconstrained flat-vector target.

This is the batched replacement for the reference's model bridges
(``TuringLogPotential`` flatten/unflatten + link/invlink in
``ext/PigeonsDynamicPPLExt``; ``StanLogPotential`` constrained transforms in
``ext/PigeonsBridgeStanExt``): instead of calling into Julia/Stan runtimes per
replica, the model is a traced JAX function over one flat float vector, so the
whole chain ladder evaluates it batched under vmap.

Conventions matching the reference:
  * the default reference is the PRIOR, which is iid-sampleable, enabling
    tempered restarts (``targets/target.jl:50-76``);
  * the annealed density is prior + beta * likelihood (linear path between
    prior and posterior);
  * initialization draws from the prior and maps to unconstrained space
    (DynamicPPL ext ``interface.jl:69-72``);
  * ``sample_names``/``extract`` return constrained-space values
    (``state.jl`` inv-link).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np

from .target import Reference, Target


class BayesianModel(Target):
    def __init__(self, priors: Dict[str, "Distribution"], log_likelihood: Callable):
        """``priors``: ordered name -> Distribution (with shape/bijector);
        ``log_likelihood(q)``: scalar traced function of the dict of
        constrained parameter values."""
        self.priors = dict(priors)
        self.log_likelihood_fn = log_likelihood
        self._slices = {}
        off = 0
        for name, dist in self.priors.items():
            self._slices[name] = (off, dist.size, dist.shape)
            off += dist.size
        self.dim = off

    # -- parameter vector <-> constrained dict -----------------------------

    def constrain(self, x):
        """Unconstrained flat vector -> (dict of constrained values, logjac)."""
        q = {}
        logjac = jnp.zeros(())
        for name, dist in self.priors.items():
            off, size, shape = self._slices[name]
            u = x[off : off + size].reshape(shape)
            val, lj = dist.bijector.forward(u)
            q[name] = val
            logjac = logjac + lj
        return q, logjac

    def unconstrain(self, q) -> jax.Array:
        parts = []
        for name, dist in self.priors.items():
            _, _, shape = self._slices[name]
            parts.append(jnp.ravel(dist.bijector.inverse(q[name])))
        return jnp.concatenate(parts) if parts else jnp.zeros((0,))

    def sample_names(self):
        """Flat constrained-variable names (reference ``sample_names``,
        ``pt/process_sample.jl:131-182``)."""
        names = []
        for name, dist in self.priors.items():
            if dist.shape == ():
                names.append(name)
            else:
                names.extend(
                    f"{name}[{i}]" for i in range(dist.size)
                )
        return names + ["log_density"]

    # -- densities in unconstrained space ----------------------------------

    def log_prior(self, x):
        q, logjac = self.constrain(x)
        lp = logjac
        for name, dist in self.priors.items():
            lp = lp + dist.log_prob(q[name])
        return lp

    def log_likelihood(self, x):
        q, _ = self.constrain(x)
        return self.log_likelihood_fn(q)

    def log_density(self, x):
        return self.log_prior(x) + self.log_likelihood(x)

    # -- target interface ---------------------------------------------------

    def default_reference(self) -> Reference:
        def sample_iid(key):
            keys = jax.random.split(key, max(len(self.priors), 1))
            q = {
                name: dist.sample(k)
                for (name, dist), k in zip(self.priors.items(), keys)
            }
            return self.unconstrain(q)

        return Reference(log_density=self.log_prior, sample_iid=sample_iid)

    def initialization(self, key):
        return self.default_reference().sample_iid(key)

    def constrained_samples(self, pt) -> Dict[str, np.ndarray]:
        """Map a PT's unconstrained trace back to constrained space."""
        xs = pt.sample_array()[:, :-1]
        f = jax.jit(jax.vmap(lambda x: self.constrain(x)[0]))
        return {k: np.asarray(v) for k, v in f(jnp.asarray(xs)).items()}
