"""Explorer combinators (reference ``src/explorers/Mix.jl``, ``Compose.jl``):
mixtures and compositions must leave the target invariant and recurse
adaptation/recorder plumbing into their components (exercised in the
reference's parallelism-invariance suite, ``test_parallelism_invariance.jl``
explorer matrix)."""

import numpy as np

from pigeons_tpu import Inputs, PT, SliceSampler, toy_mvn_target
from pigeons_tpu.ops import MALA, AutoMALA, Compose, Mix, ScanMix


def _run(explorer, seed=1):
    pt = PT(
        Inputs(
            target=toy_mvn_target(2),
            n_chains=4,
            n_rounds=7,
            seed=seed,
            explorer=explorer,
            show_report=False,
        )
    )
    pt.run()
    return pt


def test_compose_moments():
    pt = _run(Compose(SliceSampler(n_passes=1), MALA(step_size=0.3)))
    assert np.abs(pt.mean()).max() < 0.1
    assert np.abs(pt.var() - 0.1).max() < 0.06


def test_compose_recurses_adaptation():
    # AutoMALA inside a Compose must still receive its extras (step-size
    # exponents) and adapt: its step size must move from the 1.0 init
    am = AutoMALA()
    pt = _run(Compose(SliceSampler(n_passes=1), am))
    step = np.asarray(pt.exp_state[1]["step_size"])
    assert not np.allclose(step, 1.0)
    assert np.abs(pt.mean()).max() < 0.1


def test_mix_moments():
    pt = _run(Mix(SliceSampler(n_passes=1), MALA(step_size=0.3)))
    assert np.abs(pt.mean()).max() < 0.1
    assert np.abs(pt.var() - 0.1).max() < 0.06


def test_mix_supports_extras():
    # components with extra recorders get fixed slots; the selected
    # component's counts are masked by the selection, so AutoMALA's factor
    # adaptation still sees its own per-chain means and moves its step size
    am = AutoMALA()
    pt = _run(Mix(SliceSampler(n_passes=1), am))
    step = np.asarray(pt.exp_state[1]["step_size"])
    assert not np.allclose(step, 1.0)
    assert np.abs(pt.mean()).max() < 0.12
    # the unselected component's slots stay empty on those scans: counts are
    # bounded by the total scans and strictly positive overall
    extra_n = pt.reduced.extra_n
    assert extra_n.shape[1] == len(pt.explorer.extra_names)
    assert (extra_n.sum(0) > 0).all()


def test_mix_deterministic():
    a = _run(Mix(SliceSampler(n_passes=1), MALA(step_size=0.3)), seed=3)
    b = _run(Mix(SliceSampler(n_passes=1), MALA(step_size=0.3)), seed=3)
    assert np.array_equal(a.sample_array(), b.sample_array())


def test_scanmix_moments_and_adaptation():
    """ScanMix (the systematic-scan mixture — one component per
    scan, scalar switch index, only the selected branch executes) leaves the
    target invariant and still feeds each component's adaptation."""
    am = AutoMALA()
    pt = _run(ScanMix(SliceSampler(n_passes=1), am))
    assert np.abs(pt.mean()).max() < 0.12
    assert np.abs(pt.var() - 0.1).max() < 0.06
    step = np.asarray(pt.exp_state[1]["step_size"])
    assert not np.allclose(step, 1.0)
    extra_n = pt.reduced.extra_n
    assert (extra_n.sum(0) > 0).all()


def test_scanmix_deterministic():
    a = _run(ScanMix(SliceSampler(n_passes=1), MALA(step_size=0.3)), seed=3)
    b = _run(ScanMix(SliceSampler(n_passes=1), MALA(step_size=0.3)), seed=3)
    assert np.array_equal(a.sample_array(), b.sample_array())
