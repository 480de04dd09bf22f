"""AutoMALA: MALA with per-step automatic step-size selection.

Reference semantics (``src/explorers/AutoMALA.jl``, Biron-Lattes et al. 2024):
per refreshment, draw (a, b) ~ U(0,1)^2 giving log-acceptance bounds
[log min(a,b), log max(a,b)]; starting from the round's base step size, double
(grow) or halve (shrink) until the one-step leapfrog log-joint difference
enters the bounds; move with the selected step size; then re-run the search
from the proposal with flipped momentum and require the same exponent (the
reversibility check) before the MH correction. MH is skipped on the first
scan of each round (transient phase). Between rounds the base step size is
multiplied by the mean across chains of the mean selected factor 2^exponent,
and the preconditioner std deviations are re-estimated.

Batched notes: the grow/shrink search is one unified bounded
``lax.while_loop`` (direction +-1); under vmap all chains run the search in
lockstep with masking. The search is capped at ``max_exponent`` halvings/
doublings (the reference errors on float underflow instead;
``AutoMALA.jl:236-239``).

Speculative windowed search (``window=W > 0``): under vmap the batched
search loop runs until its WORST lane stops, while the mean lane needs far
fewer iterations. With ``window=W``, after the exponent-0 trial the W next
exponents in the search direction are evaluated as ONE batched leapfrog
(lane dimension x W — cheap where the matrix units are under-used at the
base batch), the per-lane stopping rule is applied by selection, and only
lanes whose search exceeds the window fall back to the sequential loop.
Selection semantics are EXACTLY the sequential search's (same exponent,
same candidate), so chains are bitwise identical (tested); only the eval
count differs (speculative trials are real evals). window=0 (sequential)
remains the default; enable it for matmul-dominated targets at
under-saturated batch sizes.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .base import Explorer, StepOut
from .hamiltonian import (
    MixDiagonalPreconditioner,
    leapfrog1_cached,
    log_joint,
    value_and_cond_grad,
)


class AutoMALA(Explorer):
    extra_names = ("am_factor", "reversibility_rate")

    def __init__(
        self,
        step_size: float = 1.0,
        base_n_refresh: int = 3,
        exponent_n_refresh: float = 0.35,
        preconditioner=None,
        max_exponent: int = 40,
        window: int = 0,
        queued: bool = False,
        queue_width: int = 0,
        queue_tail_width: int = 0,
    ):
        self.step_size = float(step_size)
        self.base_n_refresh = int(base_n_refresh)
        self.exponent_n_refresh = float(exponent_n_refresh)
        self.preconditioner = (
            preconditioner if preconditioner is not None else MixDiagonalPreconditioner()
        )
        self.max_exponent = int(max_exponent)
        # speculative search window (module docstring): 0 = sequential
        self.window = int(window)
        if not 0 <= self.window <= self.max_exponent:
            raise ValueError(
                f"window must be in [0, max_exponent]; got {self.window}"
            )
        # compacted work-queue search (step_batched below): 0 width = B//8
        self.queued = bool(queued)
        self.queue_width = int(queue_width)
        # telescoping tail (straggler attack, VERDICT r4 item 3): -1 auto =
        # max(64, Wq//8), 0 disables (default: the queue runs only a few
        # iterations, so trailing padding is not the dominant waste).
        # Results are bitwise width-independent either way (tested).
        self.queue_tail_width = int(queue_tail_width)

    @property
    def batched(self) -> bool:
        return self.queued

    def supports_ref_params(self, ref_params) -> bool:
        return True  # plain traced density queries work with any params

    def n_refresh(self, dim: int) -> int:
        return self.base_n_refresh * math.ceil(dim**self.exponent_n_refresh)

    def init_state(self, n_chains: int, dim: int):
        return {
            "step_size": jnp.full((n_chains,), self.step_size, jnp.float32),
            "std_devs": jnp.ones((n_chains, dim), jnp.float32),
        }

    def needs_online_moments(self) -> bool:
        return self.preconditioner.adapts

    def step_batched(self, keys, xs, lp0s, ld, betas, isvars, ref_params,
                     chain_params, scan_idx, ld_coord=None, coord_arrays=(),
                     compute_final_lp: bool = True) -> StepOut:
        """Whole-batch step with the compacted work-queue search (used by the
        runtime when ``queued=True``); see :func:`_queued_search`. ``keys``
        are the runtime's per-lane global-index keys, so the streams are
        layout-invariant across device meshes."""
        del ld_coord, coord_arrays, compute_final_lp
        return _batched_step_impl(
            self, keys, xs, lp0s, ld, betas, isvars, ref_params, chain_params,
            scan_idx,
        )

    def adapt(self, state, reduced, round_idx: int):
        # step size *= mean over chains of the chain-mean selected factor
        # (reference AutoMALA.jl:73-75)
        factor_mean = reduced.extra_mean[:, 0]
        observed = np.isfinite(factor_mean)
        factor = float(np.mean(factor_mean[observed])) if observed.any() else 1.0
        new_step = state["step_size"] * jnp.float32(factor)
        std_devs = state["std_devs"]
        if self.preconditioner.adapts:
            std = np.sqrt(np.maximum(reduced.online_var[:-1], 0.0))
            n = std_devs.shape[0]
            std_devs = jnp.tile(jnp.asarray(std, jnp.float32)[None, :], (n, 1))
        return {"step_size": new_step, "std_devs": std_devs}

    # -- step-size search --------------------------------------------------

    def _auto_step_size(self, lp_fn, precond, x, v, lp, cgrad, base_step,
                        lower, upper):
        """Bounded grow/shrink search for the step-size exponent.

        ``cgrad`` is the conditioned gradient at ``x`` — computed ONCE per
        refresh, so each trial step costs a single gradient evaluation (at
        its proposal) instead of two. Returns
        ``(exponent, n_leapfrogs, candidate)`` where ``candidate`` is the
        leapfrog result AT THE SELECTED step size
        (``x', v', lp', cgrad', ok``): the caller's move reuses it instead of
        integrating again (grow selects one less than the last trial, so the
        candidate is the previous iterate; shrink selects the last)."""
        h_before = log_joint(lp, v)

        def try_step(eps):
            x_n, v_n, lp_n, g_n, ok = leapfrog1_cached(
                lp_fn, precond, x, v, eps, cgrad
            )
            diff = jnp.where(ok, log_joint(lp_n, v_n) - h_before, jnp.nan)
            return diff, (x_n, v_n, lp_n, g_n, ok)

        diff0, cand0 = try_step(base_step)
        shrink = ~jnp.isfinite(diff0) | (diff0 < lower)
        grow = jnp.isfinite(diff0) & (diff0 > upper)
        direction = jnp.where(grow, 1, jnp.where(shrink, -1, 0))

        W = self.window
        if W == 0:
            n0 = jnp.zeros((), jnp.int32)
            step0 = base_step
            done0 = direction == 0
            prev0, cur0 = cand0, cand0
            extra_evals = 0.0
        else:
            # speculative window: evaluate exponents 1..W in the search
            # direction as ONE batched leapfrog (under vmap this widens the
            # density batch by W instead of deepening the sequential loop),
            # then apply the sequential stopping rule by selection — the
            # selected exponent/candidate is bitwise the sequential search's
            exps = jnp.arange(1, W + 1, dtype=base_step.dtype)
            factors = jnp.where(direction >= 0, 2.0**exps, 0.5**exps)
            diffs, cands = jax.vmap(try_step)(base_step * factors)
            cands_all = jax.tree.map(
                lambda c0, cw: jnp.concatenate([c0[None], cw], axis=0),
                cand0, cands,
            )
            stop = jnp.where(
                direction > 0,
                ~jnp.isfinite(diffs) | (diffs < upper),
                jnp.isfinite(diffs) & (diffs > lower),
            )
            stopped = jnp.any(stop) & (direction != 0)
            n_stop = (jnp.argmax(stop) + 1).astype(jnp.int32)

            def sel(idx):
                return jax.tree.map(lambda a: a[idx], cands_all)

            n0 = jnp.where(
                direction == 0, 0, jnp.where(stopped, n_stop, W)
            ).astype(jnp.int32)
            step0 = base_step * jnp.where(direction >= 0, 2.0**W, 0.5**W)
            done0 = stopped | (direction == 0)
            # residual-loop entry state mirrors the sequential carry at n0:
            # prev = candidate at exponent n0-1, cur = candidate at n0
            prev0 = sel(jnp.where(stopped, jnp.maximum(n_stop - 1, 0), W - 1))
            cur0 = sel(jnp.where(direction == 0, 0, jnp.where(stopped, n_stop, W)))
            extra_evals = float(W)

        def cond(carry):
            n, step, done, prev, cur = carry
            return ~done & (n < self.max_exponent)

        def body(carry):
            n, step, done, prev, cur = carry
            n = n + 1
            step = jnp.where(direction > 0, step * 2.0, step * 0.5)
            diff, cand = try_step(step)
            done_grow = (direction > 0) & (~jnp.isfinite(diff) | (diff < upper))
            done_shrink = (direction < 0) & jnp.isfinite(diff) & (diff > lower)
            return n, step, done_grow | done_shrink, cur, cand

        n, _, _, prev, cur = lax.while_loop(
            cond, body, (n0, step0, done0, prev0, cur0)
        )
        # grow returns n-1 (one less, avoiding the acceptance cliff); shrink -n
        exponent = jnp.where(direction > 0, n - 1, jnp.where(direction < 0, -n, 0))
        selected = jax.tree.map(
            lambda a, b: jnp.where(direction > 0, a, b), prev, cur
        )
        n_evals = (1.0 + extra_evals + (n - n0)).astype(jnp.float32)
        return exponent, n_evals, selected

    # -- full step ---------------------------------------------------------

    def step(self, key, x, lp0, lp_fn, beta, chain_params, scan_idx) -> StepOut:
        n_refresh = self.n_refresh(x.shape[0])
        base_step = chain_params["step_size"]
        std_devs = chain_params["std_devs"]
        # the reference skips MH on the first scan of each round
        use_mh = jnp.asarray(scan_idx != 1)

        def refresh(i, carry):
            x, lp, raw_grad, a_s, a_n, ns, f_s, f_n, r_s, r_n = carry
            k = jax.random.fold_in(key, i)
            k_mom, k_prec, k_a, k_b, k_mh = jax.random.split(k, 5)
            precond = self.preconditioner.build(k_prec, std_devs)
            cgrad = raw_grad / precond  # start-point gradient: carried, free
            v = jax.random.normal(k_mom, x.shape, x.dtype)
            h0 = log_joint(lp, v)
            a = jax.random.uniform(k_a)
            b = jax.random.uniform(k_b)
            lower = jnp.log(jnp.minimum(a, b))
            upper = jnp.log(jnp.maximum(a, b))

            exp_fwd, n_fwd, cand = self._auto_step_size(
                lp_fn, precond, x, v, lp, cgrad, base_step, lower, upper
            )
            # the move IS the search's selected candidate — no extra leapfrog
            x_new, v_new, lp_new, cgrad_new, ok = cand
            f_s = f_s + 2.0**exp_fwd.astype(jnp.float32)
            f_n = f_n + 1.0
            ns = ns + n_fwd

            # reversibility check from the proposal with flipped momentum,
            # seeded by the candidate's own end-point gradient (free).
            # (The reference runs it only when MH is active; mask its stats so
            # the adaptation sees the same factor stream.)
            exp_rev, n_rev, _ = self._auto_step_size(
                lp_fn, precond, x_new, -v_new, lp_new, cgrad_new, base_step,
                lower, upper
            )
            reversible = (exp_rev == exp_fwd) & ok
            f_s = f_s + jnp.where(use_mh, 2.0**exp_rev.astype(jnp.float32), 0.0)
            f_n = f_n + jnp.where(use_mh, 1.0, 0.0)
            ns = ns + jnp.where(use_mh, n_rev, 0.0)

            h1 = log_joint(lp_new, v_new)
            pr = jnp.where(reversible, jnp.minimum(1.0, jnp.exp(h1 - h0)), 0.0)
            accept = use_mh & (jax.random.uniform(k_mh) < pr) | (~use_mh & ok)
            x = jnp.where(accept, x_new, x)
            lp = jnp.where(accept, lp_new, lp)
            # carry the RAW gradient of the new state (divided by the NEXT
            # refresh's preconditioner there); candidate gradients are
            # conditioned, so un-condition on accept
            raw_grad = jnp.where(accept, cgrad_new * precond, raw_grad)
            a_s = a_s + jnp.where(use_mh, pr, 0.0)
            a_n = a_n + jnp.where(use_mh, 1.0, 0.0)
            r_s = r_s + jnp.where(use_mh, reversible.astype(jnp.float32), 0.0)
            r_n = r_n + jnp.where(use_mh, 1.0, 0.0)
            return x, lp, raw_grad, a_s, a_n, ns, f_s, f_n, r_s, r_n

        z = jnp.zeros((), jnp.float32)
        lp_start, cgrad0 = value_and_cond_grad(lp_fn, x, jnp.ones_like(x))
        del lp_start  # lp0 is the carried density; one gradient seeds the scan
        x, lp, _, a_s, a_n, ns, f_s, f_n, r_s, r_n = lax.fori_loop(
            0, n_refresh, refresh, (x, lp0, cgrad0, z, z, z + 1.0, z, z, z, z)
        )
        return StepOut(
            x, lp, a_s, a_n, ns,
            extras_sum=jnp.stack([f_s, r_s]),
            extras_n=jnp.stack([f_n, r_n]),
        )


def _queued_search(
    leap_sub, X, V, lp, cgrad, precond, base_step, lower, upper, betas, isvar,
    h_before, max_exponent: int, Wq: int, direction_of, W: int = 1,
    Wq_tail: int = 0,
):
    """Compacted work-queue form of the step-size search over a [B] batch,
    with ``W`` speculative trials per selected lane per iteration.

    The vmapped sequential search runs its ``while_loop`` until the WORST
    lane stops, and every masked lane still burns a full density+gradient
    evaluation per iteration, so masked-lane FLOPs are the efficiency gap
    (the worst lane's trials against the mean lane's). Three composable
    design rules:

    * COMPACTION: each iteration gathers the first ``Wq`` still-active lanes
      (argsort of the active mask — a [B] sort, trivial next to the matmuls),
      evaluates ONLY those, and scatters the per-lane search state back —
      masked lanes stop paying FLOPs.
    * SPECULATION (``W > 1``): each selected lane evaluates its next ``W``
      exponents in ONE widened batch and applies the sequential stopping rule
      by selection — a depth-10 lane finishes in ceil(10/W) iterations, so
      worst-lane depth no longer bounds the iteration count.
    * SCALAR CARRY: the loop carries ONLY per-lane scalars (exponent counter,
      step, done flag, eval count). Candidate states are NOT carried: the
      selected candidate is rematerialized by one full-width leapfrog at
      ``base_step * 2^exponent`` after the loop. Carrying [B, d] candidate
      arrays through a scattered while-loop made XLA round-trip them through
      layout-transposing async copies every iteration (measured: the copies
      cost more than the search's own matmuls).

    Selection semantics equal the sequential search's exactly (same exponent,
    hence bitwise the same candidate after rematerialization; tested).
    Returns (exponent [B], n_evals [B]).

    ``Wq_tail`` (> 0) adds a TELESCOPING TAIL (straggler attack, VERDICT r4
    item 3): once fewer than ``Wq_tail`` lanes remain active, the search
    drops into a second loop with queue width ``Wq_tail`` — the last few
    deep-search stragglers stop paying for a mostly-padded full-width
    queue. Selection (and the per-lane eval stats, which only count valid
    lanes) is width-independent, so results stay bitwise identical.
    """
    # trial 0: every lane needs it — full width
    x1, v2, lp1, cg1, ok = leap_sub(X, V, base_step, cgrad, precond, betas, isvar)
    diff0 = jnp.where(ok, lp1 - 0.5 * jnp.sum(v2 * v2, axis=1) - h_before, jnp.nan)
    direction = direction_of(diff0)

    B = X.shape[0]
    n = jnp.zeros((B,), jnp.int32)
    stepv = base_step
    done = direction == 0
    evals = jnp.ones((B,), jnp.float32)

    def make_cond(min_active):
        def cond(st):
            n, stepv, done, evals = st
            active = ~done & (n < max_exponent)
            if min_active:
                # hand the last few stragglers to the narrower tail loop
                return jnp.sum(active) > min_active
            return jnp.any(active)

        return cond

    def make_body(width):
        def body(st):
            n, stepv, done, evals = st
            active = ~done & (n < max_exponent)
            order = jnp.argsort(~active)  # stable: active lanes first
            idx = order[:width]
            valid = active[idx]
            d_i = direction[idx]
            # trials at exponents n+1 .. n+W in each lane's search direction
            js = jnp.arange(1, W + 1, dtype=stepv.dtype)
            fac = jnp.where(
                d_i[:, None] > 0, 2.0**js[None, :], 0.5**js[None, :]
            )
            eps = (stepv[idx][:, None] * fac).reshape(-1)  # [width*W]

            def rep(a):
                return jnp.repeat(a, W, axis=0)

            x1, v2, lp1, cg1, ok = leap_sub(
                rep(X[idx]), rep(V[idx]), eps, rep(cgrad[idx]),
                rep(precond[idx]), rep(betas[idx]), rep(isvar[idx]),
            )
            diff = jnp.where(
                ok, lp1 - 0.5 * jnp.sum(v2 * v2, axis=1) - rep(h_before[idx]),
                jnp.nan,
            ).reshape(width, W)

            stop = jnp.where(
                d_i[:, None] > 0,
                ~jnp.isfinite(diff) | (diff < upper[idx][:, None]),
                jnp.isfinite(diff) & (diff > lower[idx][:, None]),
            )  # [width, W]
            # trials past max_exponent never count (sequential cond caps there)
            j_lim = jnp.clip(max_exponent - n[idx], 0, W)  # [width]
            in_range = jnp.arange(1, W + 1)[None, :] <= j_lim[:, None]
            stop = stop & in_range
            stopped = jnp.any(stop, axis=1)
            j_stop = jnp.argmax(stop, axis=1) + 1  # first stopping trial
            j_eff = jnp.where(stopped, j_stop, j_lim)

            def upd(arr, new):
                return arr.at[idx].set(jnp.where(valid, new, arr[idx]))

            n = upd(n, n[idx] + j_eff.astype(jnp.int32))
            scale = jnp.where(d_i > 0, 2.0 ** j_eff.astype(stepv.dtype),
                              0.5 ** j_eff.astype(stepv.dtype))
            stepv = upd(stepv, stepv[idx] * scale)
            done = upd(done, stopped)
            evals = upd(evals, evals[idx] + W)  # speculative trials performed
            return n, stepv, done, evals

        return body

    st0 = (n, stepv, done, evals)
    if 0 < Wq_tail < Wq:
        st0 = lax.while_loop(make_cond(Wq_tail), make_body(Wq), st0)
        st0 = lax.while_loop(make_cond(0), make_body(Wq_tail), st0)
    else:
        st0 = lax.while_loop(make_cond(0), make_body(Wq), st0)
    n, _, _, evals = st0
    exponent = jnp.where(direction > 0, n - 1, jnp.where(direction < 0, -n, 0))
    return exponent, evals


def _batched_step_impl(explorer, keys, X, lp0, ld, betas, isvar, ref_params,
                       chain_params, scan_idx):
    """Whole-batch AutoMALA step with the compacted work-queue search.

    ``keys`` are the runtime's per-lane keys (global replica index streams);
    they reproduce the vmapped per-replica path exactly (per-refresh fold_in
    + split(5)), so the queued explorer's chains are identical to the
    sequential explorer's up to matmul batch-shape rounding (tested), and
    sharded runs are bitwise identical to serial ones."""
    B, d = X.shape
    base_step = chain_params["step_size"]  # [B]
    std_devs = chain_params["std_devs"]  # [B, d]
    n_refresh = explorer.n_refresh(d)
    use_mh = jnp.asarray(scan_idx != 1)
    Wq = explorer.queue_width or max(min(B, 128), B // 8)
    Wq = min(Wq, B)
    if explorer.queue_tail_width < 0:
        Wq_tail = min(Wq, max(64, Wq // 8))
        Wq_tail = 0 if Wq_tail >= Wq else Wq_tail
    else:
        Wq_tail = min(explorer.queue_tail_width, Wq)
    W_spec = max(1, explorer.window)  # in-queue speculation depth
    max_exponent = explorer.max_exponent

    def vgrad_sub(Xs, ps, bs, ivs):
        def f(x, p, b, iv):
            logp, g = jax.value_and_grad(lambda xx: ld(xx, b, iv, ref_params))(x)
            return logp, g / p

        return jax.vmap(f)(Xs, ps, bs, ivs)

    def leap_sub(xs, vs, eps, cg, ps, bs, ivs):
        e = eps[:, None]
        v1 = vs + 0.5 * e * cg
        x1 = xs + e * (v1 / ps)
        lp1, cg1 = vgrad_sub(x1, ps, bs, ivs)
        v2 = v1 + 0.5 * e * cg1
        ok = jnp.isfinite(lp1 - 0.5 * jnp.sum(v1 * v1, axis=1)) & jnp.isfinite(
            jnp.sum(v2 * v2, axis=1)
        )
        return x1, v2, lp1, cg1, ok

    def refresh(i, carry):
        X, lp, raw_grad, a_s, a_n, ns, f_s, f_n, r_s, r_n = carry
        ks = jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)
        k5 = jax.vmap(lambda k: jax.random.split(k, 5))(ks)  # [B, 5]
        k_mom, k_prec, k_a, k_b, k_mh = (k5[:, j] for j in range(5))
        precond = jax.vmap(explorer.preconditioner.build)(k_prec, std_devs)
        cgrad = raw_grad / precond
        V = jax.vmap(lambda k, x: jax.random.normal(k, x.shape, x.dtype))(k_mom, X)
        h0 = lp - 0.5 * jnp.sum(V * V, axis=1)
        a = jax.vmap(jax.random.uniform)(k_a)
        b = jax.vmap(jax.random.uniform)(k_b)
        lower = jnp.log(jnp.minimum(a, b))
        upper = jnp.log(jnp.maximum(a, b))

        def direction_of(diff0):
            shrink = ~jnp.isfinite(diff0) | (diff0 < lower)
            grow = jnp.isfinite(diff0) & (diff0 > upper)
            return jnp.where(grow, 1, jnp.where(shrink, -1, 0))

        exp_f, n_f = _queued_search(
            leap_sub, X, V, lp, cgrad, precond, base_step, lower, upper,
            betas, isvar, h0, max_exponent, Wq, direction_of, W=W_spec,
            Wq_tail=Wq_tail,
        )
        # rematerialize the selected candidate: one full-width leapfrog at
        # the selected step (same inputs as the winning trial -> same bits)
        eps_sel = base_step * 2.0 ** exp_f.astype(base_step.dtype)
        x_new, v_new, lp_new, cg_new, ok = leap_sub(
            X, V, eps_sel, cgrad, precond, betas, isvar
        )
        n_f = n_f + 1.0  # the rematerialization eval is performed too
        f_s = f_s + 2.0 ** exp_f.astype(jnp.float32)
        f_n = f_n + 1.0
        ns = ns + n_f

        h_prop = lp_new - 0.5 * jnp.sum(v_new * v_new, axis=1)

        def direction_rev(diff0):
            shrink = ~jnp.isfinite(diff0) | (diff0 < lower)
            grow = jnp.isfinite(diff0) & (diff0 > upper)
            return jnp.where(grow, 1, jnp.where(shrink, -1, 0))

        exp_r, n_r = _queued_search(
            leap_sub, x_new, -v_new, lp_new, cg_new, precond, base_step,
            lower, upper, betas, isvar, h_prop, max_exponent, Wq,
            direction_rev, W=W_spec, Wq_tail=Wq_tail,
        )
        reversible = (exp_r == exp_f) & ok
        f_s = f_s + jnp.where(use_mh, 2.0 ** exp_r.astype(jnp.float32), 0.0)
        f_n = f_n + jnp.where(use_mh, 1.0, 0.0)
        ns = ns + jnp.where(use_mh, n_r, 0.0)

        pr = jnp.where(reversible, jnp.minimum(1.0, jnp.exp(h_prop - h0)), 0.0)
        u_mh = jax.vmap(jax.random.uniform)(k_mh)
        accept = use_mh & (u_mh < pr) | (~use_mh & ok)
        X = jnp.where(accept[:, None], x_new, X)
        lp = jnp.where(accept, lp_new, lp)
        raw_grad = jnp.where(accept[:, None], cg_new * precond, raw_grad)
        a_s = a_s + jnp.where(use_mh, pr, 0.0)
        a_n = a_n + jnp.where(use_mh, 1.0, 0.0)
        r_s = r_s + jnp.where(use_mh, reversible.astype(jnp.float32), 0.0)
        r_n = r_n + jnp.where(use_mh, 1.0, 0.0)
        return X, lp, raw_grad, a_s, a_n, ns, f_s, f_n, r_s, r_n

    z = jnp.zeros((B,), jnp.float32)
    lp_b, cgrad0 = vgrad_sub(X, jnp.ones_like(X), betas, isvar)
    del lp_b  # lp0 is the carried density; one gradient seeds the scan
    X, lp, _, a_s, a_n, ns, f_s, f_n, r_s, r_n = lax.fori_loop(
        0, n_refresh, refresh,
        (X, lp0, cgrad0, z, z, z + 1.0, z, z, z, z),
    )
    return StepOut(
        X, lp, a_s, a_n, ns,
        extras_sum=jnp.stack([f_s, r_s], axis=1),
        extras_n=jnp.stack([f_n, r_n], axis=1),
    )
