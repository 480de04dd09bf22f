"""Batched replicate ladders (Inputs.n_replicates) and the batched slice
sweep (``ops/pallas_slice.py``).

The replicate axis is the device-level scaling feature (BASELINE north star:
vmapped chains per device): R independent PT systems share one compiled
round kernel, exploration runs as one flat batch of R*N lanes,
swaps/recorders stay per-ladder. On the CPU the sweep's Triton kernel runs in
the Pallas interpreter (``interpret=True``) and is compared bitwise with its
plain XLA twin; the compiled kernel is checked on a GPU by the ``gpu``-marked
test below and by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pigeons_tpu import Inputs, PT, SliceSampler, SliceSamplerPallas, toy_mvn_target
from pigeons_tpu import rng as prng


def test_replicates_pool_moments():
    pt = PT(
        Inputs(
            target=toy_mvn_target(3),
            n_chains=4,
            n_rounds=5,
            seed=1,
            n_replicates=16,
            show_report=False,
        )
    )
    pt.run()
    # pooled online moments across 16 ladders: much tighter than one ladder
    assert np.abs(pt.mean()).max() < 0.1
    assert np.abs(pt.var() - 0.1).max() < 0.05
    # traces pool scans x replicates x target chains
    assert pt.sample_array().shape == (2**5 * 16, 4)
    # round trips accumulate over all ladders
    assert pt.n_round_trips > 16


def test_replicates_deterministic():
    def run():
        return PT(
            Inputs(
                target=toy_mvn_target(2),
                n_chains=4,
                n_rounds=3,
                seed=7,
                n_replicates=4,
                show_report=False,
            )
        ).run()

    a, b = run(), run()
    assert np.array_equal(a.sample_array(), b.sample_array())
    assert a.n_round_trips == b.n_round_trips


from pigeons_tpu.ops import pallas_slice

_SWEEP = dict(w=10.0, p_dbl=20, n_passes=2, max_iter=1024)


def _sweep_case(B, d, seed=0):
    """A separable Gaussian with per-coordinate precisions delivered as
    coordinate arrays and a captured array constant (hoisted into the
    kernel), over a ladder of betas."""
    shift = jnp.asarray(0.25, jnp.float32)
    prec = jnp.linspace(0.5, 3.0, d)

    def coord_fn(v, c, beta, isvar, prec_c):
        return -0.5 * (0.5 + beta) * prec_c * (v - shift) ** 2

    keys = prng.keys_for(jax.random.key(seed), jnp.arange(B))
    xs = jax.random.normal(jax.random.key(seed + 1), (B, d))
    betas = jnp.linspace(0.0, 1.0, B)
    return keys, xs, betas, jnp.zeros(B), coord_fn, (prec,)


def _run_sweep(case, impl, tile=pallas_slice._TILE):
    x, stats = pallas_slice.batched_sweep(
        *case, impl=impl, tile=tile, **_SWEEP
    )
    return np.asarray(x), np.asarray(stats)


@pytest.mark.parametrize(
    "B, d, tile",
    [(8, 3, (32, 1)), (37, 11, (16, 4)), (300, 20, (64, 8))],
)
def test_sweep_interpret_matches_plain_bitwise(B, d, tile):
    # B and d are not multiples of the block: padding lanes and rows must
    # neither move real elements nor leak into the stats
    case = _sweep_case(B, d)
    xk, sk = _run_sweep(case, "interpret", tile)
    xp, sp = _run_sweep(case, "plain")
    assert np.array_equal(xk, xp)
    assert np.array_equal(sk, sp)
    assert xk.shape == (B, d) and sk.shape == (3, B)
    assert not np.allclose(xk, np.asarray(case[1]))
    # every element makes >= 2 queries per pass (its ENTER)
    assert (sk[2] >= 2 * d * _SWEEP["n_passes"]).all()


def test_sweep_tile_shape_invariance():
    case = _sweep_case(50, 9, seed=3)
    xa, sa = _run_sweep(case, "interpret", (32, 1))
    xb, sb = _run_sweep(case, "interpret", (16, 8))
    assert np.array_equal(xa, xb) and np.array_equal(sa, sb)


def test_sweep_stats_partials_match_plain():
    # 7 coordinates over row blocks of 2: four per-block partials per lane
    # are summed by XLA and must equal the plain sweep's row sums
    case = _sweep_case(20, 7, seed=5)
    _, sk = _run_sweep(case, "interpret", (16, 2))
    _, sp = _run_sweep(case, "plain")
    assert np.array_equal(sk, sp)
    assert (sk[0] <= sk[1]).all() and (sk[1] <= sk[2]).all()
    assert sk[0].sum() > 0


def test_sweep_lane_streams_use_both_key_words():
    # lanes whose first key word collides still draw distinct streams, in
    # the kernel and the plain sweep alike
    B, d = 16, 3
    x = jnp.zeros((32, d), jnp.float32)
    col = jnp.ones((32, 1), jnp.float32)
    w0 = jnp.full((32, 1), 12345, jnp.uint32)
    w1 = jnp.arange(32, dtype=jnp.uint32)[:, None] * jnp.uint32(7919)

    def ceval_fn(v, row_idx, beta, isvar, consts, cvals):
        return -0.5 * v * v

    outs = [
        f(x, col, col, w0, w1, [], [], ceval_fn, B, d, **_SWEEP, **kw)
        for f, kw in (
            (pallas_slice._sweep_plain, {}),
            (pallas_slice._sweep_pallas, dict(tile=(32, 1), interpret=True)),
        )
    ]
    (xp, sp), (xk, sk) = [(np.asarray(a), np.asarray(b)) for a, b in outs]
    assert np.array_equal(xp, xk) and np.array_equal(sp, sk)
    assert len({lane.tobytes() for lane in xp[:B]}) == B


def _correlated_gaussian():
    """A correlated (non-separable) Gaussian: no coord_log_density."""
    from pigeons_tpu.models import BayesianModel
    from pigeons_tpu.models.distributions import Normal

    def ll(q):
        x = q["x"]
        return -0.5 * (x[0] - 0.8 * x[1]) ** 2 / 0.3

    return BayesianModel({"x": Normal(shape=(2,))}, ll)


def _pt_samples(target, explorer, **kw):
    pt = PT(
        Inputs(
            target=target, n_chains=4, n_rounds=3, seed=2, explorer=explorer,
            show_report=False, **kw,
        )
    )
    pt.run()
    return pt.sample_array()


def test_sweep_routing_non_separable_takes_xla_step():
    target = _correlated_gaussian()
    a = _pt_samples(target, SliceSamplerPallas(n_passes=1))
    b = _pt_samples(target, SliceSampler(n_passes=1))
    assert np.array_equal(a, b)


def test_sweep_routing_integer_mask_takes_xla_step():
    mask = np.array([True, False, False])
    sl = SliceSamplerPallas(n_passes=1, integer_mask=mask)
    assert not sl.batched
    a = _pt_samples(toy_mvn_target(3), sl)
    b = _pt_samples(toy_mvn_target(3), SliceSampler(n_passes=1, integer_mask=mask))
    assert np.array_equal(a, b)


def _sweep_jaxpr(explorer):
    case = _sweep_case(8, 3)
    keys, xs, betas, isvars, coord_fn, (prec,) = case
    ld = lambda x, b, iv, rp: jnp.sum(x)

    def ld_coord(v, c, b, iv, rp, prec_c):
        return coord_fn(v, c, b, iv, prec_c)

    return str(jax.make_jaxpr(
        lambda k, x: explorer.step_batched(
            k, x, jnp.zeros(8), ld, betas, isvars, (), (), 1,
            ld_coord=ld_coord, coord_arrays=(prec,),
        )
    )(keys, xs))


def test_sweep_routing_no_interpret_unless_asked():
    sl = SliceSamplerPallas()
    assert sl.interpret is False
    assert "pallas_call" not in _sweep_jaxpr(sl)
    assert "pallas_call" in _sweep_jaxpr(SliceSamplerPallas(interpret=True))


def test_sweep_routing_cpu_backend_picks_plain():
    assert jax.default_backend() == "cpu"
    assert SliceSamplerPallas().sweep_impl() == "plain"
    assert SliceSamplerPallas(interpret=True).sweep_impl() == "interpret"
    with pytest.raises(ValueError, match="unknown sweep impl"):
        pallas_slice.batched_sweep(*_sweep_case(4, 2), impl="triton", **_SWEEP)


@pytest.mark.gpu
def test_sweep_kernel_matches_plain_on_gpu(gpu):
    # the compiled Triton kernel at config-1 width (d=100, 10 x 2048 lanes)
    # against its plain XLA twin: same streams, same bits
    from pigeons_tpu.paths import toy_mvn_path

    path = toy_mvn_path(100)
    B = 10 * 2048
    case = (
        prng.keys_for(jax.random.key(0), jnp.arange(B)),
        0.5 * jax.random.normal(jax.random.key(1), (B, 100)),
        jnp.tile(jnp.linspace(0.0, 1.0, 10), 2048),
        jnp.zeros(B),
        lambda v, c, b, iv: path.coord_log_density(v, c, b),
        (),
    )
    xk, sk = _run_sweep(case, "kernel")
    xp, sp = _run_sweep(case, "plain")
    assert np.array_equal(xk, xp) and np.array_equal(sk, sp)


def test_pallas_kernel_coord_delta_sweep_interpret():
    # separable density: the kernel answers proposals as O(1) deltas; the
    # returned lp must still be the exactly-recomputed density of the output
    sl = SliceSamplerPallas(interpret=True, n_passes=1)
    B, d = 8, 3
    scale = jnp.arange(1.0, d + 1.0)

    def ld(x, beta, isvar, rp):
        return -0.5 * (0.5 + beta) * jnp.sum(scale * x * x)

    def ld_coord(v, c, beta, isvar, rp):
        return -0.5 * (0.5 + beta) * scale[c] * v * v

    xs = jnp.ones((B, d))
    betas = jnp.linspace(0.0, 1.0, B)
    lp0 = jax.vmap(lambda x, b: ld(x, b, 0.0, ()))(xs, betas)
    out = sl.step_batched(
        prng.keys_for(jax.random.key(0), jnp.arange(B)), xs, lp0, ld, betas,
        jnp.zeros(B), (), (), 1,
        ld_coord=ld_coord,
    )
    lp_direct = jax.vmap(lambda x, b: ld(x, b, 0.0, ()))(out.x, betas)
    np.testing.assert_allclose(np.asarray(out.lp), np.asarray(lp_direct), atol=1e-5)
    assert not np.allclose(np.asarray(out.x), np.asarray(xs))
    assert np.asarray(out.accept_sum).sum() > 0


def test_pallas_explorer_end_to_end_interpret():
    pt = PT(
        Inputs(
            target=toy_mvn_target(2),
            n_chains=4,
            n_rounds=2,
            seed=3,
            explorer=SliceSamplerPallas(interpret=True, n_passes=1),
            show_report=False,
        )
    )
    pt.run()
    assert np.isfinite(pt.reports[-1].log_z_estimate)
    assert pt.sample_array().shape[1] == 3


@pytest.mark.slow
def test_pallas_variational_banded():
    # the variational Gaussian reference is mean-field (separable), so the
    # banded kernel runs under it: mean/std ride as banded coord blocks and
    # the run stays on the fast path through reference activation (round 6)
    pt = PT(
        Inputs(
            target=toy_mvn_target(3),
            n_chains=3,
            n_chains_variational=3,
            n_rounds=7,
            seed=5,
            explorer=SliceSamplerPallas(interpret=True, n_passes=1),
            show_report=False,
        )
    )
    pt.run()
    assert np.isfinite(pt.global_barrier_variational)
    # after the Gaussian reference activates on a Gaussian target, the
    # variational leg's barrier collapses (reference test_variational.jl:96-100)
    assert pt.global_barrier_variational < 0.5
    assert np.abs(pt.mean()).max() < 0.15


@pytest.mark.slow
def test_pallas_coord_arrays_vs_xla_moments():
    # banded kernel fed per-coordinate params must sample the same law as
    # the XLA slice sampler (distinct RNG streams: compare moments)
    import jax.numpy as jnp
    from pigeons_tpu.variational import GaussianReference

    def run(explorer):
        pt = PT(
            Inputs(
                target=toy_mvn_target(2),
                n_chains=0,
                n_chains_variational=4,
                n_rounds=8,
                seed=2,
                n_replicates=8,
                explorer=explorer,
                show_report=False,
            )
        )
        pt.run()
        return pt

    a = run(SliceSamplerPallas(interpret=True, n_passes=1))
    b = run(SliceSampler(n_passes=1))
    np.testing.assert_allclose(a.mean(), b.mean(), atol=0.08)
    np.testing.assert_allclose(a.var(), b.var(), atol=0.08)


def test_replicates_with_two_leg_variational():
    """n_replicates > 1 combined with the two-leg variational ladder
    (VERDICT r2 weak item 7): per-ladder swaps/recorders vmap over the
    two-leg layout, pooled moments stay correct, and the variational
    barrier collapses after activation."""
    pt = PT(
        Inputs(
            target=toy_mvn_target(2),
            n_chains=3,
            n_chains_variational=3,
            n_rounds=7,
            seed=6,
            n_replicates=8,
            show_report=False,
        )
    )
    pt.run()
    assert np.isfinite(pt.global_barrier_variational)
    assert pt.global_barrier_variational < 0.6
    assert np.abs(pt.mean()).max() < 0.1
    assert np.abs(pt.var() - 0.1).max() < 0.06
    # traces pool scans x replicates x BOTH junction target chains
    assert pt.sample_array().shape == (2**7 * 8 * 2, 3)
    # determinism of the combined configuration
    pt2 = PT(
        Inputs(
            target=toy_mvn_target(2),
            n_chains=3,
            n_chains_variational=3,
            n_rounds=7,
            seed=6,
            n_replicates=8,
            show_report=False,
        )
    )
    pt2.run()
    assert np.array_equal(pt.sample_array(), pt2.sample_array())
