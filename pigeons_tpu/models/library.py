"""The example-model suite, mirroring the reference's ``examples/stan/*.stan``
set plus the BASELINE.json config targets — all as traced JAX targets.

Models (reference file cited in each constructor):
  funnel, banana, unid, eight_schools (centered/noncentered), bernoulli,
  mRNA (Ballnus et al. 2017 transfection data), mvn, plus a Bayesian logistic
  regression and a hierarchical normal model for the BASELINE configs.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .bayesian import BayesianModel
from .distributions import (
    Beta,
    Cauchy,
    HalfCauchy,
    Normal,
    Uniform,
    bernoulli_logpmf,
    binomial_logpmf,
    normal_logpdf,
)
from .target import Reference, StandardNormalReference, Target


# ---------------------------------------------------------------------------
# raw (unconstrained) densities: funnel & banana
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Funnel(Target):
    """Neal's funnel (reference ``examples/stan/funnel.stan``):
    y ~ N(0, 3); x_i | y ~ N(0, exp(y / scale)). dim = `dim` + 1."""

    n_x: int = 9
    scale: float = 1.0

    @property
    def dim(self):
        return self.n_x + 1

    def log_density(self, s):
        y, x = s[0], s[1:]
        lp_y = -0.5 * (y / 3.0) ** 2 - math.log(3.0) - 0.5 * math.log(2 * math.pi)
        sd = jnp.exp(y / self.scale)
        lp_x = jnp.sum(-0.5 * (x / sd) ** 2 - jnp.log(sd) - 0.5 * math.log(2 * math.pi))
        return lp_y + lp_x

    def default_reference(self) -> Reference:
        return StandardNormalReference(self.dim, sigma=3.0).as_reference()

    def sample_iid_target(self, key):
        """Forward simulation (enables the exact invariance test)."""
        ky, kx = jax.random.split(key)
        y = 3.0 * jax.random.normal(ky)
        x = jnp.exp(y / self.scale) * jax.random.normal(kx, (self.n_x,))
        return jnp.concatenate([y[None], x])


@dataclass(frozen=True)
class Banana(Target):
    """n-dimensional banana (reference ``examples/stan/banana.stan``):
    x ~ N(0, s_a), y_i | x ~ N(x^2, scale * s_b) with a = 1/20, b = 5."""

    n_y: int = 9
    scale: float = 1.0

    @property
    def dim(self):
        return self.n_y + 1

    def log_density(self, s):
        s_a = math.sqrt(10.0)  # sqrt(1 / (2 * (1/20)))
        s_b = math.sqrt(0.1)  # sqrt(1 / (2 * 5))
        x, y = s[0], s[1:]
        lp_x = normal_logpdf(x, 0.0, s_a)
        lp_y = normal_logpdf(y, x * x, self.scale * s_b)
        return lp_x + lp_y

    def default_reference(self) -> Reference:
        return StandardNormalReference(self.dim, sigma=3.0).as_reference()

    def sample_iid_target(self, key):
        """Forward simulation (enables the exact invariance test)."""
        kx, ky = jax.random.split(key)
        s_a = math.sqrt(10.0)
        s_b = math.sqrt(0.1)
        x = s_a * jax.random.normal(kx)
        y = x * x + self.scale * s_b * jax.random.normal(ky, (self.n_y,))
        return jnp.concatenate([x[None], y])


def funnel(n_x: int = 9, scale: float = 1.0) -> Funnel:
    return Funnel(n_x, scale)


def banana(n_y: int = 9, scale: float = 1.0) -> Banana:
    return Banana(n_y, scale)


@dataclass(frozen=True)
class PoissonCount(Target):
    """Mixed integer/continuous toy target: k ~ Poisson(rate) (an ordinal
    coordinate) alongside n_cont iid N(0, 1) coordinates. Exercises the
    slice sampler's integer conventions (reference
    ``src/explorers/SliceSampler.jl:136-142,189``: integer initial window and
    inclusive-range candidate draws); the state is a float vector carrying
    whole values at the count coordinates, as in the reference's typed state.
    """

    rate: float = 5.0
    n_cont: int = 1

    @property
    def dim(self):
        return 1 + self.n_cont

    @property
    def integer_mask(self):
        import numpy as np

        m = np.zeros(self.dim, bool)
        m[0] = True
        return m

    def log_density(self, s):
        k, x = s[0], s[1:]
        valid = (k >= 0) & (jnp.abs(k - jnp.round(k)) < 0.5)
        lp_k = k * math.log(self.rate) - jax.lax.lgamma(k + 1.0) - self.rate
        lp_x = jnp.sum(-0.5 * x * x - 0.5 * math.log(2 * math.pi))
        return jnp.where(valid, lp_k + lp_x, -jnp.inf)

    def default_reference(self) -> Reference:
        # reference measure: Poisson(rate) x N(0,1), iid-sampleable — the
        # target IS the reference here, keeping the ladder trivial so tests
        # focus on the integer explorer mechanics
        return Reference(
            log_density=self.log_density, sample_iid=self.sample_iid_target
        )

    def sample_iid_target(self, key):
        kk, kx = jax.random.split(key)
        k = jax.random.poisson(kk, self.rate).astype(jnp.float32)
        x = jax.random.normal(kx, (self.n_cont,))
        return jnp.concatenate([k[None], x])

    def initialization(self, key):
        return self.sample_iid_target(key)


def poisson_count_target(rate: float = 5.0, n_cont: int = 1) -> PoissonCount:
    return PoissonCount(rate, n_cont)


@dataclass(frozen=True)
class BinaryMixture(Target):
    """Mixed Bool/continuous toy target: b_i ~ Bernoulli(p) for i = 1, 2 and
    x_j | b ~iid N(mu * (b_1 + b_2), 1). The Bool coordinates couple to the
    continuous block through the mean, so both must mix for correctness.
    Exercises the slice sampler's in-sampler exact Gibbs handling of Bool
    coordinates via ``binary_mask`` auto-detection (reference
    ``src/explorers/SliceSampler.jl:65-86`` special-cases Bools inside the
    default explorer; no manual ``Compose`` with a binary kernel needed).
    States carry {0., 1.} floats at the Bool coordinates."""

    p: float = 0.4
    mu: float = 1.5
    n_cont: int = 2

    @property
    def dim(self):
        return 2 + self.n_cont

    @property
    def binary_mask(self):
        import numpy as np

        m = np.zeros(self.dim, bool)
        m[:2] = True
        return m

    def log_density(self, s):
        b, x = s[:2], s[2:]
        valid = jnp.all((b == 0.0) | (b == 1.0))
        lp_b = jnp.sum(
            b * math.log(self.p) + (1.0 - b) * math.log(1.0 - self.p)
        )
        m = self.mu * jnp.sum(b)
        lp_x = jnp.sum(-0.5 * (x - m) ** 2 - 0.5 * math.log(2 * math.pi))
        return jnp.where(valid, lp_b + lp_x, -jnp.inf)

    def default_reference(self) -> Reference:
        # Bern(1/2) on the Bool block, N(0, 3) on the continuous block —
        # iid-sampleable and covering the target's support
        n_c = self.n_cont

        def ref_log_density(s):
            b, x = s[:2], s[2:]
            valid = jnp.all((b == 0.0) | (b == 1.0))
            lp = -2.0 * math.log(2.0) + jnp.sum(
                -0.5 * (x / 3.0) ** 2 - math.log(3.0) - 0.5 * math.log(2 * math.pi)
            )
            return jnp.where(valid, lp, -jnp.inf)

        def ref_sample(key):
            kb, kx = jax.random.split(key)
            b = jax.random.bernoulli(kb, 0.5, (2,)).astype(jnp.float32)
            x = 3.0 * jax.random.normal(kx, (n_c,))
            return jnp.concatenate([b, x])

        return Reference(log_density=ref_log_density, sample_iid=ref_sample)

    def sample_iid_target(self, key):
        kb, kx = jax.random.split(key)
        b = (jax.random.uniform(kb, (2,)) < self.p).astype(jnp.float32)
        x = self.mu * jnp.sum(b) + jax.random.normal(kx, (self.n_cont,))
        return jnp.concatenate([b, x])

    def initialization(self, key):
        return self.default_reference().sample_iid(key)


def binary_mixture_target(p: float = 0.4, mu: float = 1.5, n_cont: int = 2) -> BinaryMixture:
    return BinaryMixture(p, mu, n_cont)


# ---------------------------------------------------------------------------
# Bayesian models (priors + likelihood, constrained parameters)
# ---------------------------------------------------------------------------


def unid_target(n_trials: int = 100, n_successes: int = 50) -> BayesianModel:
    """Unidentifiable binomial (reference ``examples/stan/unid.stan``):
    p1, p2 ~ U(0,1); successes ~ Binomial(trials, p1*p2). Used by the
    reference's 2-leg stepping-stone test with exact logZ."""

    def log_likelihood(q):
        return binomial_logpmf(
            float(n_successes), float(n_trials), q["p1"] * q["p2"]
        )

    return BayesianModel(
        {"p1": Uniform(), "p2": Uniform()}, log_likelihood
    )


def unid_analytic_log_z(n_trials: int = 100, n_successes: int = 50) -> float:
    """Exact log marginal likelihood of the unid model (the reference computes
    this oracle in test/supporting/analytic_solutions.jl via the Beta
    integral of P(S = s | p = p1 p2) over the uniform priors)."""
    from scipy.integrate import dblquad
    from scipy.stats import binom

    val, _ = dblquad(
        lambda p2, p1: binom.pmf(n_successes, n_trials, p1 * p2),
        0.0, 1.0, 0.0, 1.0,
    )
    return float(np.log(val))


_EIGHT_SCHOOLS_Y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
_EIGHT_SCHOOLS_SIGMA = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]


def eight_schools(centered: bool = False) -> BayesianModel:
    """Eight schools (reference ``examples/stan/eight_schools_*.stan`` with
    ``examples/stan/eight_schools.json`` data)."""
    y = jnp.asarray(_EIGHT_SCHOOLS_Y)
    sigma = jnp.asarray(_EIGHT_SCHOOLS_SIGMA)

    if centered:
        # theta's true prior is the CONDITIONAL N(mu, tau); the sampleable
        # reference uses a pseudo-prior N(0, 20) which is divided back out of
        # the likelihood term, so target = reference + likelihood is exactly
        # the posterior while the reference stays iid-sampleable
        def log_likelihood(q):
            theta, mu, tau = q["theta"], q["mu"], q["tau"]
            pseudo = normal_logpdf(theta, 0.0, 20.0)
            return (
                normal_logpdf(theta, mu, tau)
                + normal_logpdf(y, theta, sigma)
                - pseudo
            )

        return BayesianModel(
            {"theta": Normal(shape=(8,), scale=20.0), "mu": Normal(scale=5.0),
             "tau": HalfCauchy(scale=5.0)},
            log_likelihood,
        )

    def log_likelihood(q):
        theta = q["theta_trans"] * q["tau"] + q["mu"]
        return normal_logpdf(y, theta, sigma)

    return BayesianModel(
        {"theta_trans": Normal(shape=(8,)), "mu": Normal(scale=5.0),
         "tau": HalfCauchy(scale=5.0)},
        log_likelihood,
    )


def bernoulli_target(data=None) -> BayesianModel:
    """Reference ``examples/stan/bernoulli.stan``: theta ~ Beta(1,1)."""
    if data is None:
        data = [0, 1, 0, 0, 0, 0, 0, 0, 0, 1]
    y = jnp.asarray(np.asarray(data, dtype=np.float32))
    return BayesianModel(
        {"theta": Beta(1.0, 1.0)},
        lambda q: bernoulli_logpmf(y, q["theta"]),
    )


def _load_mrna_data():
    path = os.path.join(os.path.dirname(__file__), "data", "Ballnus_et_al_2017_M1a.csv")
    raw = np.loadtxt(path, delimiter=",")
    return raw[:, 0], raw[:, 1]


def mrna_target() -> BayesianModel:
    """mRNA transfection model (reference ``examples/stan/mRNA.stan``,
    Ballnus et al. 2017 data): five log10-scale parameters with uniform
    priors; mu(t) = km0/(delta-beta) (e^{-beta(t-t0)} - e^{-delta(t-t0)})
    computed with the expm1 trick for delta ~ beta."""
    ts_np, ys_np = _load_mrna_data()
    ts = jnp.asarray(ts_np, jnp.float32)
    ys = jnp.asarray(ys_np, jnp.float32)

    def get_mu(tmt0, km0, beta, delta):
        dmb = delta - beta
        # exp(a) - exp(b) = -1{a>b} e^a expm1(b-a) + 1{a<=b} e^b expm1(a-b)
        a, b = -beta * tmt0, -delta * tmt0
        diff = jnp.where(
            a > b, -jnp.exp(a) * jnp.expm1(b - a), jnp.exp(b) * jnp.expm1(a - b)
        )
        near = jnp.abs(dmb) < 1e-7
        val = km0 * jnp.where(near, tmt0, diff / jnp.where(near, 1.0, dmb))
        return jnp.where(tmt0 <= 0.0, 0.0, val)

    def log_likelihood(q):
        t0 = 10.0 ** q["lt0"]
        km0 = 10.0 ** q["lkm0"]
        beta = 10.0 ** q["lbeta"]
        delta = 10.0 ** q["ldelta"]
        sigma = 10.0 ** q["lsigma"]
        mu = get_mu(ts - t0, km0, beta, delta)
        return normal_logpdf(ys, mu, sigma)

    return BayesianModel(
        {
            "lt0": Uniform(-2.0, 1.0),
            "lkm0": Uniform(-5.0, 5.0),
            "lbeta": Uniform(-5.0, 5.0),
            "ldelta": Uniform(-5.0, 5.0),
            "lsigma": Uniform(-2.0, 2.0),
        },
        log_likelihood,
    )


def mvn_target(dim: int, precision: float = 1.0) -> Target:
    """Reference ``examples/stan/mvn.stan`` (flat-prior isotropic Gaussian)."""
    d = int(dim)  # class bodies resolve `dim = dim` against globals, not here

    @dataclass(frozen=True)
    class MVN(Target):
        dim: int = d

        def log_density(self, x):
            return -0.5 * precision * jnp.sum(x * x)

        def default_reference(self) -> Reference:
            return StandardNormalReference(self.dim, sigma=2.0 / math.sqrt(precision)).as_reference()

    return MVN()


def logistic_regression(n: int = 200, d: int = 10, seed: int = 0) -> BayesianModel:
    """Bayesian logistic regression on synthetic data (BASELINE.json config 2:
    'Bayesian logistic regression posterior with AutoMALA explorer')."""
    key = jax.random.key(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    X = jax.random.normal(k1, (n, d))
    w_true = jax.random.normal(k2, (d,))
    logits = X @ w_true
    y = (jax.random.uniform(k3, (n,)) < jax.nn.sigmoid(logits)).astype(jnp.float32)

    def log_likelihood(q):
        logits = X @ q["w"] + q["b"]
        # y*log sigma(z) + (1-y)*log sigma(-z) == y*z - softplus(z): one
        # transcendental per point instead of two
        return jnp.sum(y * logits - jax.nn.softplus(logits))

    return BayesianModel(
        {"w": Normal(shape=(d,), scale=2.0), "b": Normal(scale=2.0)},
        log_likelihood,
    )


def hierarchical_normal(n_groups: int = 20, n_per_group: int = 10, seed: int = 0) -> BayesianModel:
    """Hierarchical normal model on synthetic data (BASELINE.json config 5:
    'hierarchical model target' for the multi-host run)."""
    key = jax.random.key(seed)
    k1, k2 = jax.random.split(key)
    mu_true = 1.0
    group_means = mu_true + 0.7 * jax.random.normal(k1, (n_groups,))
    data = group_means[:, None] + 0.5 * jax.random.normal(k2, (n_groups, n_per_group))

    def log_likelihood(q):
        theta = q["mu"] + q["theta_trans"] * q["tau"]  # non-centered
        return normal_logpdf(data, theta[:, None], q["sigma"])

    return BayesianModel(
        {
            "theta_trans": Normal(shape=(n_groups,)),
            "mu": Normal(scale=5.0),
            "tau": HalfCauchy(scale=2.5),
            "sigma": HalfCauchy(scale=2.5),
        },
        log_likelihood,
    )
