"""Gradient explorer tests mirroring the reference's test strategy
(test/test_auto_mala.jl, test_mala.jl, test_AAPS.jl), scaled for CI time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pigeons_tpu import (
    AAPS,
    AutoMALA,
    DiagonalPreconditioner,
    IdentityPreconditioner,
    Inputs,
    MALA,
    PT,
    toy_mvn_target,
)
from pigeons_tpu.models.target import Reference, Target
from pigeons_tpu.ops.hamiltonian import leapfrog


class HetPrecisionNormal(Target):
    """Independent Gaussian with per-coordinate precisions (the reference's
    HetPrecisionNormalLogPotential fixture, test/supporting/*)."""

    def __init__(self, precisions):
        self.precisions = np.asarray(precisions, dtype=np.float32)
        self.dim = len(self.precisions)

    def log_density(self, x):
        return -0.5 * jnp.sum(jnp.asarray(self.precisions) * x * x)

    def default_reference(self) -> Reference:
        dim = self.dim
        return Reference(
            log_density=lambda x: -0.5 * jnp.sum(x * x),
            sample_iid=lambda key: jax.random.normal(key, (dim,)),
        )


def run(target, explorer, n_rounds=8, n_chains=4, seed=1):
    pt = PT(
        Inputs(
            target=target,
            n_chains=n_chains,
            n_rounds=n_rounds,
            seed=seed,
            explorer=explorer,
            show_report=False,
        )
    )
    return pt.run()


def test_leapfrog_involutive():
    """Reversed, momentum-flipped leapfrog returns to the start
    (reference test_auto_mala.jl Hamiltonian involutivity check)."""
    key = jax.random.key(0)
    lp_fn = lambda x: -0.5 * jnp.sum(x * x * jnp.arange(1.0, 5.0))
    x = jax.random.normal(key, (4,))
    v = jax.random.normal(jax.random.fold_in(key, 1), (4,))
    precond = jnp.full((4,), 1.3)
    x1, v1, _, ok = leapfrog(lp_fn, precond, x, v, 0.1, n_steps=5)
    x2, v2, _, _ = leapfrog(lp_fn, precond, x1, -v1, 0.1, n_steps=5)
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x), atol=1e-4)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(-v), atol=1e-4)


def test_mala_moments():
    pt = run(toy_mvn_target(2), MALA(step_size=0.5), n_rounds=9)
    np.testing.assert_allclose(pt.mean(), 0.0, atol=0.05)
    np.testing.assert_allclose(pt.var(), 0.1, atol=0.05)


def test_automala_moments_and_acceptance():
    pt = run(toy_mvn_target(2), AutoMALA(), n_rounds=9)
    np.testing.assert_allclose(pt.mean(), 0.0, atol=0.05)
    np.testing.assert_allclose(pt.var(), 0.1, atol=0.05)
    # reference test_auto_mala.jl:44-48: mean MH acceptance > 0.4
    assert np.nanmean(pt.reduced.exp_accept) > 0.4


def test_aaps_moments():
    pt = run(toy_mvn_target(2), AAPS(step_size=0.3), n_rounds=9)
    np.testing.assert_allclose(pt.mean(), 0.0, atol=0.06)
    np.testing.assert_allclose(pt.var(), 0.1, atol=0.05)


@pytest.mark.parametrize("dim", [1, 10, 100])
def test_automala_acceptance_across_dims(dim):
    """Reference test_auto_mala.jl:44-48 (dims 1..1000; trimmed for CI)."""
    pt = run(toy_mvn_target(dim), AutoMALA(), n_rounds=7, n_chains=3)
    assert np.nanmean(pt.reduced.exp_accept) > 0.4


def test_automala_step_size_dimensional_scaling():
    """Step size shrinks with dimension, but by less than d^(1/3)
    (reference test_auto_mala.jl:27-34)."""

    def adapted_step(dim):
        pt = run(toy_mvn_target(dim), AutoMALA(), n_rounds=8, n_chains=3)
        return float(np.asarray(pt.exp_state["step_size"][0]))

    s1 = adapted_step(1)
    s64 = adapted_step(64)
    assert s64 < s1
    assert s1 / s64 < 64.0 ** (1.0 / 3.0) * 2.0  # slack for short runs


def test_mass_matrix_adaptation():
    """DiagonalPreconditioner recovers the target std devs
    (reference test_auto_mala.jl:36-41: precisions [500, 1])."""
    target = HetPrecisionNormal([500.0, 1.0])
    pt = run(
        target,
        AutoMALA(preconditioner=DiagonalPreconditioner()),
        n_rounds=10,
        n_chains=4,
    )
    stds = np.asarray(pt.exp_state["std_devs"][0])
    assert abs(stds[0] - 1.0 / np.sqrt(500.0)) < 0.01
    assert abs(stds[1] - 1.0) < 0.2


def test_automala_reversibility_rate_recorded():
    pt = run(toy_mvn_target(3), AutoMALA(), n_rounds=6)
    i = AutoMALA.extra_names.index("reversibility_rate")
    rates = pt.reduced.extra_mean[:, i]
    assert np.all(pt.reduced.extra_n[:, i] > 0)  # recorded at every chain
    assert np.nanmean(rates) > 0.6  # mostly reversible on a Gaussian


def test_identity_preconditioner_no_adaptation():
    pt = run(toy_mvn_target(2), MALA(step_size=0.5, preconditioner=IdentityPreconditioner()), n_rounds=5)
    np.testing.assert_array_equal(np.asarray(pt.exp_state["std_devs"]), 1.0)


@pytest.mark.slow
def test_nuts_moments_and_adaptation():
    # NUTS (not in the reference; BASELINE north star) must recover the toy
    # posterior, adapt its step size toward the 0.8 acceptance target, and
    # produce round trips through the ladder
    from pigeons_tpu import NUTS

    pt = PT(
        Inputs(
            target=toy_mvn_target(10),
            n_chains=8,
            n_rounds=9,
            seed=1,
            explorer=NUTS(step_size=0.5),
            show_report=False,
        )
    ).run()
    assert np.abs(pt.mean()).max() < 0.08
    assert np.abs(pt.var() - 0.1).max() < 0.05
    assert abs(pt.reports[-1].log_z_estimate - pt.path.analytic_lognormalization()) < 0.5
    assert pt.n_round_trips > 5
    acc = pt.reduced.extra_mean[:, 0]
    assert 0.5 < np.nanmean(acc) <= 1.0
    depth = pt.reduced.extra_mean[:, 1]
    assert 1.0 <= np.nanmean(depth) < 8.0


@pytest.mark.slow
def test_automala_step_size_round_convergence():
    """Reference ``test/test_auto_mala.jl:17-26``: the adapted step size
    agrees between a 10-round and a 15-round run (rtol 0.1) on a 1-d toy
    MVN with a single chain."""

    def step_at(n_rounds):
        pt = run(toy_mvn_target(1), AutoMALA(), n_rounds=n_rounds, n_chains=1)
        return float(np.asarray(pt.exp_state["step_size"])[0])

    s10 = step_at(10)
    s15 = step_at(15)
    np.testing.assert_allclose(s10, s15, rtol=0.1)


@pytest.mark.slow
def test_preconditioner_ess_ordering():
    """Reference ``test/test_auto_mala.jl`` "Preconditioners: normal target"
    block: on a scale-mismatched Gaussian (precisions [100, 0.01]), the
    minimum per-dimension ESS is ordered
    Identity < MixDiagonal < Diagonal (~12 / ~849 / ~3945 in the reference)."""
    from pigeons_tpu import MixDiagonalPreconditioner
    from pigeons_tpu.diagnostics import ess

    target = HetPrecisionNormal([100.0, 0.01])

    def min_ess(precond):
        pt = run(
            target, AutoMALA(preconditioner=precond), n_rounds=12, n_chains=1
        )
        sa = pt.sample_array()
        return min(ess(sa[:, j]) for j in range(2))

    e_id = min_ess(IdentityPreconditioner())
    e_mix = min_ess(MixDiagonalPreconditioner())
    e_diag = min_ess(DiagonalPreconditioner())
    assert e_id < e_mix < e_diag, (e_id, e_mix, e_diag)


def test_queued_automala_bitwise_equals_sequential():
    """The compacted work-queue search (AutoMALA(queued=True), the large-batch
    fast path) must select the same exponent and
    candidate as the sequential search: full runs agree bitwise, including
    with in-queue speculation (window > 1)."""
    import jax

    from pigeons_tpu import Inputs, PT, toy_mvn_target

    def go(**kw):
        pt = PT(
            Inputs(
                target=toy_mvn_target(8),
                n_chains=6,
                n_rounds=5,
                seed=3,
                explorer=AutoMALA(**kw),
                show_report=False,
            )
        )
        pt.run()
        return pt

    a = go()
    for kw in (
        dict(queued=True, queue_width=4),
        dict(queued=True, queue_width=8, window=3),
    ):
        b = go(**kw)
        np.testing.assert_array_equal(
            np.asarray(a.states), np.asarray(b.states), err_msg=str(kw)
        )
        np.testing.assert_array_equal(a.sample_array(), b.sample_array())
        np.testing.assert_array_equal(
            np.asarray(a.exp_state["step_size"]),
            np.asarray(b.exp_state["step_size"]),
        )
        assert (
            a.reports[-1].log_z_estimate == b.reports[-1].log_z_estimate
        ), kw


def test_windowed_automala_bitwise_equals_sequential():
    """The vmapped speculative window (AutoMALA(window=W)) replicates the
    sequential stopping rule by selection — full runs agree bitwise."""
    from pigeons_tpu import Inputs, PT, toy_mvn_target

    def go(**kw):
        pt = PT(
            Inputs(
                target=toy_mvn_target(5),
                n_chains=4,
                n_rounds=5,
                seed=7,
                explorer=AutoMALA(**kw),
                show_report=False,
            )
        )
        pt.run()
        return pt

    a = go()
    b = go(window=3)
    np.testing.assert_array_equal(np.asarray(a.states), np.asarray(b.states))
    np.testing.assert_array_equal(a.sample_array(), b.sample_array())
