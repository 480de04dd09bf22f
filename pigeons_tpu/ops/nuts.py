"""NUTS: the No-U-Turn Sampler (multinomial variant), batched.

Not present in the reference (Pigeons.jl ships SliceSampler/MALA/AutoMALA/
AAPS); included because a dynamic-trajectory HMC kernel is table stakes for a
gradient-model engine (BASELINE.json north star names it explicitly).
Algorithm: Hoffman & Gelman 2014 with Betancourt's multinomial state
selection and Stan's biased progressive sampling across doublings.

Batched structure (everything bounded, vmappable per lane):

  * Iterative doubling: a ``lax.while_loop`` over tree depth; each doubling
    extends the trajectory by ``2^depth`` single leapfrog steps via
    ``lax.fori_loop`` (one gradient evaluation per leaf — (lp, grad) carried
    between leaves, never recomputed).
  * Sub-U-turn checks without recursion: a checkpoint stack of
    ``max_depth`` states. Using 1-based leaf index i within the subtree,
    leaf i STARTS a balanced range of size 2^m iff i = 1 (mod 2^m) (the state
    is stored in slot m), and ENDS one iff i = 0 (mod 2^m) (the U-turn test
    runs against slot m). Every balanced subtree is checked exactly at its
    final leaf — equivalent to the recursive rule.
  * Backward expansion reuses the forward machine on (x, -v) (leapfrog is
    time-symmetric), so leaf order always looks forward in the subtree's own
    time and the U-turn formula needs no direction cases.
  * The U-turn criterion matches the velocity parameterization of the
    integrator (``hamiltonian.py``: dx/dt = v / diag_precond):
    turning iff dot(dx, v_start/precond) < 0 or dot(dx, v_end/precond) < 0.

Between rounds the step size follows a per-round Robbins-Monro update toward
``target_accept`` (bounded to [x1/2, x2] per round) and the preconditioner
re-estimates — the same adaptation cadence as AutoMALA.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .base import Explorer, StepOut
from .hamiltonian import MixDiagonalPreconditioner, log_joint, value_and_cond_grad


class NUTS(Explorer):
    extra_names = ("nuts_accept", "tree_depth")

    def __init__(
        self,
        step_size: float = 1.0,
        max_depth: int = 8,
        preconditioner=None,
        divergence_threshold: float = 1000.0,
        target_accept: float = 0.8,
    ):
        self.step_size = float(step_size)
        self.max_depth = int(max_depth)
        self.preconditioner = (
            preconditioner if preconditioner is not None else MixDiagonalPreconditioner()
        )
        self.divergence_threshold = float(divergence_threshold)
        self.target_accept = float(target_accept)

    def init_state(self, n_chains: int, dim: int):
        return {
            "step_size": jnp.full((n_chains,), self.step_size, jnp.float32),
            "std_devs": jnp.ones((n_chains, dim), jnp.float32),
        }

    def needs_online_moments(self) -> bool:
        return self.preconditioner.adapts

    def adapt(self, state, reduced, round_idx: int):
        acc_mean = reduced.extra_mean[:, 0]
        observed = np.isfinite(acc_mean)
        acc = float(np.mean(acc_mean[observed])) if observed.any() else self.target_accept
        factor = float(np.clip(math.exp(acc - self.target_accept), 0.5, 2.0))
        new_step = state["step_size"] * jnp.float32(factor)
        std_devs = state["std_devs"]
        if self.preconditioner.adapts:
            std = np.sqrt(np.maximum(reduced.online_var[:-1], 0.0))
            n = std_devs.shape[0]
            std_devs = jnp.tile(jnp.asarray(std, jnp.float32)[None, :], (n, 1))
        return {"step_size": new_step, "std_devs": std_devs}

    # ------------------------------------------------------------------

    def step(self, key, x, lp0, lp_fn, beta, chain_params, scan_idx) -> StepOut:
        d = x.shape[0]
        D = self.max_depth
        eps = chain_params["step_size"].astype(x.dtype)
        k_prec, k_mom, k_tree = jax.random.split(jax.random.fold_in(key, 0), 3)
        precond = self.preconditioner.build(k_prec, chain_params["std_devs"])

        def uturn(x_s, v_s, x_e, v_e):
            dx = x_e - x_s
            return (jnp.dot(dx, v_s / precond) < 0.0) | (
                jnp.dot(dx, v_e / precond) < 0.0
            )

        def leaf_step(xc, vc, lpc, gc):
            """One leapfrog with carried gradient: 1 new gradient eval."""
            v_half = vc + 0.5 * eps * gc
            x_n = xc + eps * (v_half / precond)
            lp_n, g_n = value_and_cond_grad(lp_fn, x_n, precond)
            v_n = v_half + 0.5 * eps * g_n
            return x_n, v_n, lp_n, g_n

        v0 = jax.random.normal(k_mom, x.shape, x.dtype)
        lp_init, g0 = value_and_cond_grad(lp_fn, x, precond)
        h0 = log_joint(lp_init, v0)

        fz = jnp.zeros((), jnp.float32)

        def build_subtree(k_sub, x_end, v_end, g_end, lp_end, depth):
            """Extend 2^depth leaves forward from (x_end, v_end); returns the
            subtree's proposal, weight, end state, and stop flags."""
            ckpt_x = jnp.zeros((D, d), x.dtype)
            ckpt_v = jnp.zeros((D, d), x.dtype)
            init = (
                x_end, v_end, lp_end, g_end,  # current leaf
                -jnp.inf, x_end, lp_end,  # lsw_sub, x_prop_sub, lp_prop_sub
                jnp.asarray(False), jnp.asarray(False),  # turned, diverged
                ckpt_x, ckpt_v,
                fz, fz,  # acc_sum, n_leaps
            )

            def leaf(j, carry):
                (xc, vc, lpc, gc, lsw_sub, xp, lpp, turned, diverged,
                 ckpt_x, ckpt_v, acc_sum, n_leaps) = carry
                stop = turned | diverged
                x_n, v_n, lp_n, g_n = leaf_step(xc, vc, lpc, gc)
                w = log_joint(lp_n, v_n) - h0
                div_n = ~jnp.isfinite(w) | (w < -self.divergence_threshold)
                w_safe = jnp.where(div_n, -jnp.inf, w)

                # progressive multinomial within the subtree
                lsw_new = jnp.logaddexp(lsw_sub, w_safe)
                u = jax.random.uniform(jax.random.fold_in(k_sub, j))
                take = jnp.log(u) < (w_safe - lsw_new)

                # checkpoint stack: store starts, test ends (1-based index i)
                i = j + 1
                turn_new = jnp.asarray(False)
                for m in range(1, D + 1):
                    period = 2**m
                    starts = (i % period) == 1 if period > 1 else True
                    ends = (i % period) == 0
                    sm = jnp.asarray(starts)
                    ckpt_x = ckpt_x.at[m - 1].set(
                        jnp.where(sm, x_n, ckpt_x[m - 1])
                    )
                    ckpt_v = ckpt_v.at[m - 1].set(
                        jnp.where(sm, v_n, ckpt_v[m - 1])
                    )
                    turn_new = turn_new | (
                        jnp.asarray(ends) & uturn(ckpt_x[m - 1], ckpt_v[m - 1], x_n, v_n)
                    )

                acc_leaf = jnp.exp(jnp.minimum(w_safe, 0.0))
                new = (
                    x_n, v_n, lp_n, g_n,
                    lsw_new,
                    jnp.where(take, x_n, xp),
                    jnp.where(take, lp_n, lpp),
                    turned | turn_new,
                    diverged | div_n,
                    ckpt_x, ckpt_v,
                    acc_sum + acc_leaf,
                    n_leaps + 1.0,
                )
                # frozen once stopped (divergence/U-turn ends the subtree)
                return jax.tree.map(
                    lambda a, b: jnp.where(stop, a, b), carry, new
                )

            n_leaves = jnp.int32(1) << depth
            out = lax.fori_loop(0, n_leaves, leaf, init)
            (xc, vc, lpc, gc, lsw_sub, xp, lpp, turned, diverged,
             _, _, acc_sum, n_leaps) = out
            return xc, vc, lpc, gc, lsw_sub, xp, lpp, turned | diverged, acc_sum, n_leaps

        # trajectory state: ends carry forward-time velocities; expansion uses
        # (x, -v) for the left end so subtrees always build forward
        init = (
            x, v0, g0, x, v0, g0,  # x_l, v_l, g_l, x_r, v_r, g_r
            lp_init, lp_init,  # lp_l, lp_r
            x, lp_init, fz.astype(x.dtype) + 0.0,  # x_prop, lp_prop, lsw(=0)
            jnp.zeros((), jnp.int32),  # depth
            jnp.asarray(False),  # done
            fz, fz,  # acc_sum, n_leaps
        )

        def cond(st):
            return (~st[12]) & (st[11] < D)

        def body(st):
            (x_l, v_l, g_l, x_r, v_r, g_r, lp_l, lp_r,
             x_prop, lp_prop, lsw, depth, done, acc_sum, n_leaps) = st
            k_d = jax.random.fold_in(k_tree, depth)
            k_dir, k_take, k_sub = jax.random.split(k_d, 3)
            go_right = jax.random.bernoulli(k_dir)

            xe = jnp.where(go_right, x_r, x_l)
            ve = jnp.where(go_right, v_r, -v_l)
            ge = jnp.where(go_right, g_r, g_l)
            lpe = jnp.where(go_right, lp_r, lp_l)

            (xn, vn, lpn, gn, lsw_sub, xp_sub, lpp_sub, stopped_sub,
             acc_add, leaps_add) = build_subtree(k_sub, xe, ve, ge, lpe, depth)

            # merge only a completed subtree (Stan: an internally-terminated
            # doubling contributes no sample and ends the trajectory)
            valid = ~stopped_sub
            take_pr = jnp.exp(jnp.minimum(lsw_sub - lsw, 0.0))  # biased progressive
            take = valid & (jax.random.uniform(k_take) < take_pr)
            x_prop = jnp.where(take, xp_sub, x_prop)
            lp_prop = jnp.where(take, lpp_sub, lp_prop)
            lsw = jnp.where(valid, jnp.logaddexp(lsw, lsw_sub), lsw)

            # new trajectory end (map the subtree's forward velocity back)
            upd_r = valid & go_right
            upd_l = valid & ~go_right
            x_r = jnp.where(upd_r, xn, x_r)
            v_r = jnp.where(upd_r, vn, v_r)
            g_r = jnp.where(upd_r, gn, g_r)
            lp_r = jnp.where(upd_r, lpn, lp_r)
            x_l = jnp.where(upd_l, xn, x_l)
            v_l = jnp.where(upd_l, -vn, v_l)
            g_l = jnp.where(upd_l, gn, g_l)
            lp_l = jnp.where(upd_l, lpn, lp_l)

            turn_full = uturn(x_l, v_l, x_r, v_r)
            done = ~valid | turn_full
            return (x_l, v_l, g_l, x_r, v_r, g_r, lp_l, lp_r,
                    x_prop, lp_prop, lsw, depth + 1, done,
                    acc_sum + acc_add, n_leaps + leaps_add)

        st = lax.while_loop(cond, body, init)
        x_prop, lp_prop = st[8], st[9]
        depth, acc_sum, n_leaps = st[11], st[13], st[14]
        acc_mean = jnp.where(n_leaps > 0, acc_sum / n_leaps, jnp.nan)
        return StepOut(
            x_prop,
            lp_prop,
            accept_sum=acc_sum,
            accept_n=n_leaps,
            # gradient evaluations: one per leaf + the initial one
            n_steps=n_leaps + 1.0,
            extras_sum=jnp.stack([acc_mean, depth.astype(jnp.float32)]),
            extras_n=jnp.stack([jnp.float32(1.0), jnp.float32(1.0)]),
        )
