"""Recorders: fixed-shape statistic accumulators carried through the scan loop.

The reference implements recorders as per-replica mutable accumulators merged
across threads/processes with a deterministic tree reduction at round end
(``src/recorders/recorders.jl:88-130``, ``src/mpi_utils/Entangler.jl:214-297``).
The batched equivalent: every recorder is a fixed-shape array in the
``lax.scan`` carry, updated with gathers/scatters keyed by chain index; the
"reduction" is just pulling the (replicated) arrays to host at round end.
Because updates happen in canonical chain order inside a single traced program,
the result is independent of the device layout by construction — the analogue
of the reference's parallelism invariance.

Recorder inventory mapped from reference ``src/recorders/recorder.jl``:
  * swap_acceptance_pr (GroupBy pair -> Mean)        -> accept_sum / accept_n
  * log_sum_ratio (GroupBy pair -> streaming LogSum) -> lsr_* (running logsumexp)
  * round_trip (3-state machine per replica)         -> rt_state / rt_restarts / rt_trips
  * online, _transformed_online (mean/var)           -> online_* over extract(x, lp)
  * energy_ac1 (CovMatrix(2) per chain)              -> energy [N, 6]
  * explorer_acceptance_pr / explorer_n_steps        -> exp_*
  * index_process, traces                            -> per-scan scan outputs (pt.py)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def kadd(acc, delta):
    """Kahan-compensated accumulation for f32 carries.

    ``acc`` is a ``[2, ...]`` stack of (running sum, compensation). The
    reference accumulates its online statistics in Float64 OnlineStats
    (``recorders/recorder.jl:93-102``); the carries here are f32, and
    compensated summation recovers ~f64 accuracy for long rounds (2^r scans): the
    compensation row carries what each add rounds away — including whole
    increments once counts pass 2^24, where plain f32 addition silently
    drops them."""
    val, comp = acc[0], acc[1]
    # f64 deltas (Inputs.dtype=float64 runs) are folded into the f32
    # compensated accumulator so the scan carry keeps one stable dtype
    delta = jnp.asarray(delta, val.dtype)
    y = delta - comp
    t = val + y
    comp_new = (t - val) - y
    return jnp.stack([t, comp_new])


def kinit(*shape, dtype=jnp.float32):
    return jnp.zeros((2,) + tuple(shape), dtype)


class Recorders(NamedTuple):
    # swap statistics, indexed by pair = lower chain, length N-1.
    # Additive accumulators are [2, ...] Kahan stacks (see kadd).
    accept_sum: jax.Array
    accept_n: jax.Array
    lsr_fwd: jax.Array  # running logsumexp of forward log-ratios
    lsr_fwd_n: jax.Array
    lsr_bwd: jax.Array
    lsr_bwd_n: jax.Array
    # round-trip state machine per replica (reference RoundTripRecorder.jl:4-52)
    rt_state: jax.Array  # int32[N] in {0, 1, 2}
    rt_restarts: jax.Array  # int32[N]
    rt_trips: jax.Array  # int32[N]
    # online moments of extract(x, lp) at the target chain, length d+1
    online_n: jax.Array
    online_sum: jax.Array
    online_sumsq: jax.Array
    # energy before/after exploration, per chain: (n, sx, sy, sxx, syy, sxy)
    energy: jax.Array  # [N, 6]
    # explorer statistics per chain
    exp_accept_sum: jax.Array
    exp_accept_n: jax.Array
    exp_steps: jax.Array
    # explorer-specific per-chain stats [N, K] (e.g. AutoMALA am_factors /
    # reversibility_rate — the analogue of opt-in recorder builders)
    extra_sum: jax.Array
    extra_n: jax.Array


def init_recorders(n_chains: int, extract_dim: int, n_extras: int = 0) -> Recorders:
    n, m = n_chains, max(n_chains - 1, 1)
    f = jnp.float32
    return Recorders(
        accept_sum=kinit(m),
        accept_n=kinit(m),
        lsr_fwd=jnp.full(m, -jnp.inf, f),
        lsr_fwd_n=jnp.zeros(m, f),
        lsr_bwd=jnp.full(m, -jnp.inf, f),
        lsr_bwd_n=jnp.zeros(m, f),
        rt_state=jnp.zeros(n, jnp.int32),
        rt_restarts=jnp.zeros(n, jnp.int32),
        rt_trips=jnp.zeros(n, jnp.int32),
        online_n=kinit(),
        online_sum=kinit(extract_dim),
        online_sumsq=kinit(extract_dim),
        energy=kinit(n, 6),
        exp_accept_sum=kinit(n),
        exp_accept_n=kinit(n),
        exp_steps=kinit(n),
        extra_sum=kinit(n, n_extras),
        extra_n=kinit(n, n_extras),
    )


def update_round_trips(rec: Recorders, is_ref, is_target) -> Recorders:
    """Per-replica 3-state machine, fed (is_ref, is_target) of the pre-swap
    chain each scan (reference ``RoundTripRecorder.jl:46-52`` driven from
    ``swap.jl:106-126``)."""
    s = rec.rt_state
    to1 = (s == 0) & is_ref
    to2 = (s == 1) & is_target
    trip = (s == 2) & is_ref
    new_state = jnp.where(to1 | trip, 1, jnp.where(to2, 2, s))
    return rec._replace(
        rt_state=new_state.astype(rec.rt_state.dtype),
        rt_restarts=rec.rt_restarts + to2.astype(rec.rt_restarts.dtype),
        rt_trips=rec.rt_trips + trip.astype(rec.rt_trips.dtype),
    )


def update_logsum(lse, n, value, active):
    """Streaming logsumexp (reference ``recorders/LogSum.jl``), masked."""
    new_lse = jnp.logaddexp(lse, jnp.asarray(value, lse.dtype))
    return jnp.where(active, new_lse, lse), n + active.astype(n.dtype)


class ReducedRecorders(NamedTuple):
    """Host-side (numpy, float64) snapshot of one round's recorders."""

    accept_mean: np.ndarray  # [N-1], 0.5-filled later by adaptation
    accept_n: np.ndarray
    lsr_fwd: np.ndarray
    lsr_fwd_n: np.ndarray
    lsr_bwd: np.ndarray
    lsr_bwd_n: np.ndarray
    n_tempered_restarts: int
    n_round_trips: int
    online_n: float
    online_mean: np.ndarray  # [d+1] (last entry: log density)
    online_var: np.ndarray
    energy_ac1: np.ndarray  # [N]
    exp_accept: np.ndarray  # [N]
    exp_steps: np.ndarray  # [N]
    extra_mean: np.ndarray  # [N, K] per-chain means of explorer extras
    extra_n: np.ndarray  # [N, K]


def merge_replicates(host: Recorders) -> Recorders:
    """Merge the leading replicate axis of a batched recorder pytree (already
    resolved to f64 values on host).

    All accumulators are additive except the streaming logsumexps, which merge
    with logaddexp (reference ``recorders/LogSum.jl`` merge), and the round-trip
    machine state, which is per-ladder and not meaningfully poolable."""
    return host._replace(
        accept_sum=host.accept_sum.sum(0),
        accept_n=host.accept_n.sum(0),
        lsr_fwd=np.logaddexp.reduce(host.lsr_fwd, axis=0),
        lsr_fwd_n=host.lsr_fwd_n.sum(0),
        lsr_bwd=np.logaddexp.reduce(host.lsr_bwd, axis=0),
        lsr_bwd_n=host.lsr_bwd_n.sum(0),
        rt_state=host.rt_state[0],
        rt_restarts=host.rt_restarts.sum(0),
        rt_trips=host.rt_trips.sum(0),
        online_n=host.online_n.sum(0),
        online_sum=host.online_sum.sum(0),
        online_sumsq=host.online_sumsq.sum(0),
        energy=host.energy.sum(0),
        exp_accept_sum=host.exp_accept_sum.sum(0),
        exp_accept_n=host.exp_accept_n.sum(0),
        exp_steps=host.exp_steps.sum(0),
        extra_sum=host.extra_sum.sum(0),
        extra_n=host.extra_n.sum(0),
    )


_KAHAN_FIELDS = (
    "accept_sum", "accept_n", "online_n", "online_sum", "online_sumsq",
    "energy", "exp_accept_sum", "exp_accept_n", "exp_steps", "extra_sum",
    "extra_n",
)


def reduce_recorders(rec: Recorders, n_replicates: int = 1) -> ReducedRecorders:
    from .parallel.sharding import to_host

    host = jax.tree.map(lambda a: np.asarray(to_host(a), dtype=np.float64), rec)
    # resolve compensated stacks to f64 values: true sum = sum - compensation
    # (the [2, ...] stack axis sits after the replicate axis when batched)
    k_axis = 1 if n_replicates > 1 else 0
    host = host._replace(
        **{
            f: np.take(getattr(host, f), 0, axis=k_axis)
            - np.take(getattr(host, f), 1, axis=k_axis)
            for f in _KAHAN_FIELDS
        }
    )
    if n_replicates > 1:
        host = merge_replicates(host)
    with np.errstate(invalid="ignore", divide="ignore"):
        accept_mean = np.where(host.accept_n > 0, host.accept_sum / np.maximum(host.accept_n, 1), np.nan)
        n = host.online_n
        mean = host.online_sum / max(n, 1.0)
        var = host.online_sumsq / max(n, 1.0) - mean**2
        var = np.maximum(var, 0.0) * (n / max(n - 1.0, 1.0))  # unbiased-ish
        # lag-1 energy autocorrelation per chain from the 2x2 cov accumulator
        en = host.energy
        cnt = np.maximum(en[:, 0], 1.0)
        mx, my = en[:, 1] / cnt, en[:, 2] / cnt
        vx = en[:, 3] / cnt - mx**2
        vy = en[:, 4] / cnt - my**2
        cxy = en[:, 5] / cnt - mx * my
        ac1 = np.where((vx > 0) & (vy > 0), cxy / np.sqrt(np.maximum(vx * vy, 1e-300)), np.nan)
        exp_accept = np.where(host.exp_accept_n > 0, host.exp_accept_sum / np.maximum(host.exp_accept_n, 1), np.nan)
        extra_mean = np.where(host.extra_n > 0, host.extra_sum / np.maximum(host.extra_n, 1), np.nan)
    return ReducedRecorders(
        accept_mean=accept_mean,
        accept_n=host.accept_n,
        lsr_fwd=host.lsr_fwd,
        lsr_fwd_n=host.lsr_fwd_n,
        lsr_bwd=host.lsr_bwd,
        lsr_bwd_n=host.lsr_bwd_n,
        n_tempered_restarts=int(host.rt_restarts.sum()),
        n_round_trips=int(host.rt_trips.sum()),
        online_n=float(n),
        online_mean=mean,
        online_var=var,
        energy_ac1=ac1,
        exp_accept=exp_accept,
        exp_steps=host.exp_steps,
        extra_mean=extra_mean,
        extra_n=host.extra_n,
    )
