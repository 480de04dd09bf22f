"""Smoke test of pigeons_tpu on a GPU, through the entry points a user calls.

    python chip_smoke.py              # phases 0-7 on one card
    python chip_smoke.py --devices 4  # only the sharded runs, on four cards

Phases on one card:

0. the device: nvidia-smi's name and power limit, JAX's devices; stops
   unless JAX's default backend is a GPU;
1. ``pigeons()`` on the d=100 toy MVN with its default (iid) explorer,
   checked against the analytic moments, logZ and barrier, and with the
   XLA slice sampler, checked against the analytic moments;
2. config-1 width (10 chains x 2048 replicates) with the batched slice
   sampler: analytic moments, one sweep of the Triton kernel against its
   plain XLA twin, and a 32-scan round timed each way;
3. the two-leg variational ladder (10+10 chains x 256 replicates) on the
   batched sampler: the variational barrier collapses;
4. queued AutoMALA on logistic regression (n=4096, d=256, 10 x 819 lanes):
   a finite logZ, and density and gradient at 64 states against a float64
   NumPy reference;
5. determinism: phase 1's slice-sampler run twice, bitwise equal samples;
6. the serial check (``checked_round``) in a child process on the same card;
7. a host-callback target (``ExternalTarget``) running on the card.

``--devices 4`` runs a chain-sharded (16 chains) and a replicate-sharded
(2048 replicates) ladder over four cards, with the batched and the XLA slice
sampler, each compared bitwise with its one-card twin in this process.

Each phase prints one line; any failure exits non-zero before the last line,
which is the JSON object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"),
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pigeons_tpu import (  # noqa: E402
    PT,
    AutoMALA,
    Inputs,
    SliceSampler,
    SliceSamplerPallas,
    pigeons,
    toy_mvn_target,
)
from pigeons_tpu import rng as prng  # noqa: E402

DIM = 100
N_CHAINS = 10
N_REPLICATES = 2048
LOGREG_N, LOGREG_D, LOGREG_REPLICATES = 4096, 256, 819


class _PlainSweep(SliceSamplerPallas):
    """The batched sampler with its plain XLA sweep: the kernel's control."""

    def sweep_impl(self) -> str:
        return "plain"


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


_T0 = time.perf_counter()


def _phase(name: str, **numbers) -> None:
    numbers["elapsed_s"] = round(time.perf_counter() - _T0, 1)
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in numbers.items()), flush=True)


def phase0_device(n_devices: int):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    devs = jax.devices()
    print(" ".join(f"{d}:{d.device_kind}" for d in devs), flush=True)
    _check(jax.default_backend() == "gpu", f"backend is {jax.default_backend()}, not gpu")
    _check(len(devs) >= n_devices, f"{n_devices} devices needed, {len(devs)} found")
    return devs


def _phase1_run(n_rounds, **kw):
    return pigeons(
        target=toy_mvn_target(DIM), n_chains=N_CHAINS, n_rounds=n_rounds,
        seed=1, show_report=False, **kw,
    )


def phase1_default():
    # the default explorer of the toy MVN draws iid at every beta, so logZ
    # and the barrier can be held to the analytic values
    pt = _phase1_run(8)
    path = pt.path
    mean, var = pt.mean()[:DIM], pt.var()[:DIM]
    logz, logz_a = pt.reports[-1].log_z_estimate, path.analytic_lognormalization()
    bar, bar_a = pt.global_barrier, float(path.analytic_cumulative_barrier(1.0))
    # the XLA slice sampler on the same ladder, held to the analytic moments
    sl = _phase1_run(8, explorer=SliceSampler())
    sl_mean, sl_var = sl.mean()[:DIM], sl.var()[:DIM]
    _phase(
        "1 default path", mean=float(mean.mean()), var=float(var.mean()),
        logZ=logz, logZ_analytic=logz_a, barrier=bar, barrier_analytic=bar_a,
        slice_mean=float(sl_mean.mean()), slice_var=float(sl_var.mean()),
    )
    for name, m, v in (("default", mean, var), ("slice", sl_mean, sl_var)):
        _check(abs(float(m.mean())) < 0.02, f"{name} mean")
        _check(abs(float(v.mean()) - 0.1) < 0.01, f"{name} var")
    _check(abs(logz - logz_a) < 0.5, "logZ")
    # each of the 9 pairs' rejection rate is below 1, so 10 chains cannot
    # reach the analytic 9.16, and saturated pairs bias the estimate low
    _check(0.7 * bar_a < bar < 1.05 * bar_a, "barrier")


def _config1(explorer):
    pt = PT(
        Inputs(
            target=toy_mvn_target(DIM), n_chains=N_CHAINS, n_rounds=4,
            n_replicates=N_REPLICATES, seed=1, explorer=explorer,
            show_report=False,
        )
    )
    while pt.round_idx < 4:
        pt.run_round(n_scans=4)
    return pt


def _timed_rounds(pt, n_scans=32, n=3):
    pt.run_round(n_scans=n_scans)  # compile
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        pt.run_round(n_scans=n_scans)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase2_batched():
    pt = _config1(SliceSamplerPallas())
    mean, var = pt.mean()[:DIM], pt.var()[:DIM]
    _phase(
        "2 config-1 moments", max_abs_mean=float(np.abs(mean).max()),
        max_abs_var_err=float(np.abs(var - 0.1).max()),
    )
    _check(float(np.abs(mean).max()) < 0.05, "config-1 mean")
    _check(float(np.abs(var - 0.1).max()) < 0.02, "config-1 var")

    # one sweep, kernel against plain, on the same inputs at this width
    path = pt.path
    B = N_CHAINS * N_REPLICATES
    keys = prng.keys_for(jax.random.key(0), jnp.arange(B))
    xs = 0.5 * jax.random.normal(jax.random.key(1), (B, DIM))
    betas = jnp.tile(jnp.linspace(0.0, 1.0, N_CHAINS), N_REPLICATES)
    ld = lambda x, b, iv, rp: path.log_density(x, b)
    ldc = lambda v, c, b, iv, rp: path.coord_log_density(v, c, b)

    def sweep(explorer):
        f = jax.jit(
            lambda k, x, b: explorer.step_batched(
                k, x, jnp.zeros(B), ld, b, jnp.zeros(B), (), (), 1,
                ld_coord=ldc, compute_final_lp=False,
            )
        )
        compiled = f.lower(keys, xs, betas).compile()
        return compiled, compiled(keys, xs, betas)

    ck, ok_ = sweep(SliceSamplerPallas())
    _, op_ = sweep(_PlainSweep())
    a = np.asarray(ok_.x)
    b = np.asarray(op_.x)
    stats_equal = all(
        np.array_equal(np.asarray(getattr(ok_, f)), np.asarray(getattr(op_, f)))
        for f in ("accept_sum", "accept_n", "n_steps")
    )
    # tolerance: bitwise. Both builds run the same float32 operations on the
    # same counter-based draws; on the H100 they agree exactly.
    _phase(
        "2 kernel vs plain", max_abs_diff=float(np.abs(a - b).max()),
        share_differ=float(np.mean(a != b)), stats_equal=stats_equal,
        tolerance="bitwise", temp_bytes=ck.memory_analysis().temp_size_in_bytes,
    )
    _check(np.array_equal(a, b) and stats_equal, "kernel differs from plain")

    t_kernel = _timed_rounds(pt)
    t_plain = _timed_rounds(_config1(_PlainSweep()))
    _phase(
        "2 32-scan round ms", kernel=[round(t, 3) for t in t_kernel],
        plain=[round(t, 3) for t in t_plain],
        kernel_median=float(np.median(t_kernel)),
        plain_median=float(np.median(t_plain)),
    )


def phase3_variational():
    pt = PT(
        Inputs(
            target=toy_mvn_target(DIM), n_chains=N_CHAINS,
            n_chains_variational=N_CHAINS, n_rounds=7, n_replicates=256,
            seed=1, explorer=SliceSamplerPallas(), show_report=False,
        )
    )
    pt.run()
    bv = pt.global_barrier_variational
    _phase("3 variational", barrier_variational=bv, barrier_fixed=pt.global_barrier)
    _check(bv < 0.5, "variational barrier did not collapse")


def _logreg_reference(n, d, xs):
    """float64 NumPy density and gradient of ``logistic_regression(n, d)``
    (prior N(0, 2^2) on w and b) at the states ``xs [S, d + 1]``."""
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    X = jax.random.normal(k1, (n, d))
    y = jax.random.uniform(k3, (n,)) < jax.nn.sigmoid(X @ jax.random.normal(k2, (d,)))
    X, y = np.asarray(X, np.float64), np.asarray(y, np.float64)
    lps, grads = [], []
    for x in np.asarray(xs, np.float64):
        w, b = x[:d], x[d]
        z = X @ w + b
        p = 1.0 / (1.0 + np.exp(-z))
        prior = np.sum(-0.5 * (np.log(2 * np.pi) + (x / 2.0) ** 2) - np.log(2.0))
        lps.append(prior + np.sum(y * z - np.logaddexp(0.0, z)))
        r = y - p
        grads.append(np.concatenate([X.T @ r - w / 4.0, [r.sum() - b / 4.0]]))
    return np.asarray(lps), np.asarray(grads)


def phase4_automala():
    from pigeons_tpu.models import logistic_regression

    n, d = LOGREG_N, LOGREG_D
    target = logistic_regression(n, d)
    pt = PT(
        Inputs(
            target=target, n_chains=N_CHAINS, n_rounds=3,
            n_replicates=LOGREG_REPLICATES,
            seed=1, explorer=AutoMALA(queued=True, queue_width=512, window=2),
            show_report=False,
        )
    )
    pt.run()
    logz = pt.reports[-1].log_z_estimate

    xs = 0.05 * jax.random.normal(jax.random.key(2), (64, d + 1))
    ref_lp, ref_g = _logreg_reference(n, d, xs)
    vg = jax.jit(jax.vmap(jax.value_and_grad(target.log_density)))

    def errs(lp, g):
        lp, g = np.asarray(lp, np.float64), np.asarray(g, np.float64)
        e_lp = float(np.max(np.abs(lp - ref_lp) / np.abs(ref_lp)))
        e_g = float(np.max(
            np.linalg.norm(g - ref_g, axis=1) / np.linalg.norm(ref_g, axis=1)
        ))
        return e_lp, e_g

    e_lp, e_g = errs(*vg(xs))
    with jax.default_matmul_precision("highest"):
        h_lp, h_g = errs(*jax.jit(jax.vmap(jax.value_and_grad(target.log_density)))(xs))
    # the default precision runs f32 matmuls in TF32 when its gradient error
    # is well above the "highest"-precision one
    in_effect = "tf32" if e_g > 10 * h_g else "f32"
    _phase(
        "4 automala", logZ=logz, rel_err_density=e_lp, rel_err_grad=e_g,
        rel_err_density_highest=h_lp, rel_err_grad_highest=h_g,
        default_matmul_precision=jax.config.jax_default_matmul_precision,
        matmul_precision_in_effect=in_effect,
    )
    _check(np.isfinite(logz), "AutoMALA logZ not finite")
    _check(e_lp < 1e-3 and e_g < 1e-2, "logistic regression density/gradient")


def phase5_determinism():
    a, b = (_phase1_run(6, explorer=SliceSampler()) for _ in range(2))
    same = np.array_equal(a.sample_array(), b.sample_array())
    _phase("5 determinism", bitwise_equal=same, xla_flags=os.environ.get("XLA_FLAGS", ""))
    _check(same, "two identical runs differ")


def phase6_serial_check():
    t0 = time.perf_counter()
    pt = pigeons(
        target=toy_mvn_target(DIM), n_chains=N_CHAINS, n_rounds=4,
        checked_round=3, checkpoint=True, seed=1,
        explorer=SliceSamplerPallas(), show_report=False,
    )
    _phase("6 serial check", rounds=pt.round_idx, seconds=time.perf_counter() - t0)


def phase7_host_callback():
    from pigeons_tpu.models import ExternalTarget

    target = ExternalTarget(
        lambda xb: -0.5 * np.sum(xb * xb, axis=1).astype(np.float32), dim=4
    )
    pt = pigeons(target=target, n_chains=4, n_rounds=3, seed=1, show_report=False)
    platform = next(iter(pt.states.devices())).platform
    logz = pt.reports[-1].log_z_estimate
    _phase("7 host callback", state_platform=platform, logZ=logz)
    _check(platform == "gpu", "host-evaluated target left the GPU")
    _check(np.isfinite(logz), "host-callback logZ not finite")


def sharded(devices):
    from pigeons_tpu.parallel import replica_mesh

    mesh = replica_mesh(devices)

    def go(mesh, **kw):
        pt = PT(
            Inputs(
                target=toy_mvn_target(DIM), seed=1, show_report=False,
                mesh=mesh, n_rounds=3, **kw,
            )
        )
        for _ in range(3):
            pt.run_round(n_scans=32)
        return pt

    layouts = {
        "chain-sharded": dict(n_chains=16),
        "replicate-sharded": dict(n_chains=N_CHAINS, n_replicates=N_REPLICATES),
    }
    for layout, kw in layouts.items():
        for name, make in (("batched", SliceSamplerPallas), ("xla", SliceSampler)):
            t0 = time.perf_counter()
            a, b = go(mesh, explorer=make(), **kw), go(None, explorer=make(), **kw)
            same = np.array_equal(a.sample_array(), b.sample_array()) and all(
                (ra.log_z_estimate, ra.n_round_trips, ra.n_tempered_restarts)
                == (rb.log_z_estimate, rb.n_round_trips, rb.n_tempered_restarts)
                for ra, rb in zip(a.reports, b.reports)
            )
            _phase(
                f"{layout} {name}", devices=len(devices), bitwise_equal=same,
                trips=sum(r.n_round_trips for r in a.reports),
                seconds=time.perf_counter() - t0,
            )
            _check(same, f"{layout} {name} differs from its one-card twin")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)
    devs = phase0_device(args.devices)
    if args.devices == 4:
        sharded(devs[:4])
    else:
        phase1_default()
        phase2_batched()
        phase3_variational()
        phase4_automala()
        phase5_determinism()
        phase6_serial_check()
        phase7_host_callback()
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }))


if __name__ == "__main__":
    sys.exit(main())
