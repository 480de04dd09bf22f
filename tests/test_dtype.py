"""Inputs.dtype: f64 opt-in for ill-conditioned targets (VERDICT r3 item 7).

The reference computes in Float64 throughout (``src/pt/state.jl``, all
explorers). The build defaults to f32 (Kahan recorders recover accumulation
accuracy) but must offer an f64 escape hatch
for densities whose f32 evaluation saturates — e.g. a deep funnel where
``exp(y)`` underflows f32 and the x-term becomes inf.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

from pigeons_tpu import Inputs, PT
from pigeons_tpu.models import funnel


def test_f32_density_saturates_to_guarded_inf():
    """At y = -100 the funnel's exp(y) underflows f32 to 0, so the density
    evaluates to -inf (the runtime's NaN guard keeps kernels rejecting
    instead of freezing); the same state is finite in f64 — see the
    subprocess test below."""
    t = funnel(2)
    s = jnp.asarray([-100.0, 1.0, 1.0], jnp.float32)
    lp = float(t.log_density(s))
    assert not np.isfinite(lp)


def test_f64_requires_x64_mode():
    with pytest.raises(ValueError, match="x64"):
        PT(Inputs(target=funnel(2), n_chains=2, dtype=jnp.float64))


_F64_SCRIPT = textwrap.dedent(
    """
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import jax.numpy as jnp
    from pigeons_tpu import Inputs, PT, SliceSampler, toy_mvn_target
    from pigeons_tpu.models import funnel

    # the f32-saturating state evaluates finite in f64
    t = funnel(2)
    s = jnp.asarray([-100.0, 1.0, 1.0], jnp.float64)
    lp = float(t.log_density(s))
    assert np.isfinite(lp), lp

    # end-to-end f64 run on the deep funnel
    pt = PT(Inputs(
        target=t, n_chains=4, n_rounds=5, seed=1, dtype=jnp.float64,
        explorer=SliceSampler(n_passes=1), show_report=False,
    ))
    pt.run()
    assert pt.states.dtype == jnp.float64
    sa = pt.sample_array()
    assert sa.dtype == np.float64 and np.isfinite(sa).all()
    assert np.isfinite(pt.mean()).all()
    assert np.isfinite(pt.reports[-1].log_z_estimate)

    # posterior-moment parity holds in f64 too (reference test_moments.jl)
    pt2 = PT(Inputs(
        target=toy_mvn_target(2), n_chains=4, n_rounds=9, seed=1,
        dtype=jnp.float64, show_report=False,
    ))
    pt2.run()
    assert np.all(np.abs(pt2.mean()) < 0.06), pt2.mean()
    assert np.all(np.abs(pt2.var() - 0.1) < 0.05), pt2.var()
    print("F64-OK")
    """
)


def test_f64_run_end_to_end_subprocess():
    """x64 mode is a process-global JAX flag, so the f64 suite runs in a
    subprocess (the in-process suite stays f32)."""
    env = dict(os.environ)
    env["JAX_ENABLE_X64"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault(
        "JAX_COMPILATION_CACHE_DIR", os.path.expanduser("~/.cache/jax_tests_f64")
    )
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    out = subprocess.run(
        [sys.executable, "-c", _F64_SCRIPT],
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr[-3000:]}"
    assert "F64-OK" in out.stdout
