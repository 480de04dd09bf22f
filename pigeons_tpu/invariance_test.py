"""Exact Invariance Test (modified Geweke): does one explorer step leave the
target invariant?

Reference semantics (``src/explorers/invariance_test.jl`` +
``ext/PigeonsHypothesisTestsExt``): draw N iid samples from the target via
forward simulation; for each, optionally take ONE explorer step; compare the
marginals of the stepped vs unstepped batches with two-sample KS tests using a
Bonferroni-corrected p-value threshold (default 0.005). A correct invariant
kernel passes; a buggy one fails.

Batched: the reference loops N times serially; here both batches are one
vmapped computation (10k chains' steps fused into a single XLA program).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import rng as prng


class InvarianceTestResult(NamedTuple):
    passed: bool
    pvalues: np.ndarray
    failed_dims: np.ndarray


def invariance_test(
    target,
    explorer,
    seed: int = 1,
    n_iid_samples: int = 10_000,
    marginal_pvalue_threshold: float = 0.005,
) -> InvarianceTestResult:
    """The target must support iid sampling of the TARGET distribution:
    either ``sample_iid_target(key)`` or a path iid-sampleable at beta = 1
    (toy paths, reference ``invariance_test.jl:46-56``)."""
    sampler = _target_sampler(target)
    key = prng.master_key(seed)
    k_init, k_final, k_step = jax.random.split(key, 3)

    d = target.dim
    chain_params = jax.tree.map(
        lambda a: a[0], explorer.init_state(1, d)
    )

    del k_step

    def draw(k):
        return sampler(k)

    init_keys = prng.replica_keys(k_init, n_iid_samples)
    final_keys = prng.replica_keys(k_final, n_iid_samples)
    initial = np.asarray(jax.jit(jax.vmap(draw))(init_keys))

    def draw_and_step_keyed(k):
        x = sampler(k)
        lp_fn = target.log_density
        out = explorer.step(
            jax.random.fold_in(k, 1), x, lp_fn(x), lp_fn, 1.0, chain_params, 2
        )
        return out.x

    final = np.asarray(jax.jit(jax.vmap(draw_and_step_keyed))(final_keys))

    from scipy.stats import ks_2samp

    pvalues = np.array(
        [ks_2samp(initial[:, j], final[:, j]).pvalue for j in range(d)]
    )
    threshold = marginal_pvalue_threshold / d  # Bonferroni
    failed = np.where(pvalues < threshold)[0]
    return InvarianceTestResult(bool(len(failed) == 0), pvalues, failed)


def _target_sampler(target):
    if hasattr(target, "sample_iid_target"):
        return target.sample_iid_target
    path = getattr(target, "path", None)
    if path is not None and getattr(path, "has_iid_reference", False) and hasattr(
        path, "sample_at"
    ):
        return lambda key: path.sample_at(key, 1.0)
    raise ValueError(
        "invariance_test needs a target with sample_iid_target(key) or an "
        "iid-sampleable toy path"
    )
