"""AAPS: the Apogee-to-Apogee Path Sampler (Sherlock et al. 2022).

Reference semantics (``src/explorers/AAPS.jl``): from (x, v ~ N(0, I)), extend
forward and backward trajectories segmented at apogees (sign changes of
v . M^{-1/2} grad log pi, i.e. local maxima of the energy); K+1 segments are
sampled in total (initial forward + backward pair, then K more continuing a
randomly chosen endpoint); within every segment each visited state z gets
weight log_joint(z) + Gumbel noise and the running argmax is the proposal
(Gumbel-max trick == sampling w.p. proportional to exp(log-joint); scheme (1)
of the paper, acceptance probability 1). A divergent leapfrog anywhere bails
the whole move back to the initial position.

Batched notes: segments run as bounded ``lax.while_loop``s (cap
``max_segment_steps``, a deviation from the reference's unbounded loops —
hitting the cap is treated as a divergence); the backward trajectory skips its
first state to avoid double counting (reference ``skip_first``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .base import Explorer, StepOut
from .hamiltonian import MixDiagonalPreconditioner, log_joint, value_and_cond_grad


class AAPS(Explorer):
    def __init__(
        self,
        step_size: float = 1.0,
        K: int = 5,
        preconditioner=None,
        max_segment_steps: int = 256,
    ):
        self.step_size = float(step_size)
        self.K = int(K)
        self.preconditioner = (
            preconditioner if preconditioner is not None else MixDiagonalPreconditioner()
        )
        self.max_segment_steps = int(max_segment_steps)

    def init_state(self, n_chains: int, dim: int):
        return {"std_devs": jnp.ones((n_chains, dim), jnp.float32)}

    def needs_online_moments(self) -> bool:
        return self.preconditioner.adapts

    def adapt(self, state, reduced, round_idx: int):
        if not self.preconditioner.adapts:
            return state
        std = np.sqrt(np.maximum(reduced.online_var[:-1], 0.0))
        n = state["std_devs"].shape[0]
        return {"std_devs": jnp.tile(jnp.asarray(std, jnp.float32)[None, :], (n, 1))}

    def _segment(self, key, lp_fn, precond, x, v, skip_first):
        """Extend (x, v) until the next apogee; returns
        (x_end, v_end, wmax, x_at_wmax, n_steps, valid)."""
        eps = self.step_size
        lp, cgrad = value_and_cond_grad(lp_fn, x, precond)
        w0 = jnp.where(
            skip_first,
            -jnp.inf,
            log_joint(lp, v) + jax.random.gumbel(jax.random.fold_in(key, 0)),
        )

        def cond(carry):
            i, x, v, lp, cgrad, old_sign, wmax, xmax, done, ok = carry
            return ~done & (i < self.max_segment_steps)

        def body(carry):
            i, x, v, lp, cgrad, old_sign, wmax, xmax, done, ok = carry
            # one leapfrog (merged-form; 1 gradient eval reusing the cached one)
            v_half = v + 0.5 * eps * cgrad
            x_n = x + eps * (v_half / precond)
            lp_n, cgrad_n = value_and_cond_grad(lp_fn, x_n, precond)
            v_n = v_half + 0.5 * eps * cgrad_n
            ok_n = ok & jnp.isfinite(log_joint(lp_n, v_n))
            new_sign = jnp.sign(jnp.sum(v_n * cgrad_n))
            apogee = (old_sign < 0) & (new_sign > 0)
            w = log_joint(lp_n, v_n) + jax.random.gumbel(jax.random.fold_in(key, i + 1))
            better = ok_n & ~apogee & (w > wmax)
            wmax_n = jnp.where(better, w, wmax)
            xmax_n = jnp.where(better, x_n, xmax)
            return (
                i + 1, x_n, v_n, lp_n, cgrad_n, new_sign,
                wmax_n, xmax_n, apogee | ~ok_n, ok_n,
            )

        init_sign = jnp.sign(jnp.sum(v * cgrad))
        i, x_e, v_e, _, _, _, wmax, xmax, _, ok = lax.while_loop(
            cond,
            body,
            (jnp.zeros((), jnp.int32), x, v, lp, cgrad, init_sign,
             w0, x, jnp.asarray(False), jnp.asarray(True)),
        )
        # hitting the cap without an apogee counts as invalid (bail)
        ok = ok & (i < self.max_segment_steps)
        return x_e, v_e, wmax, xmax, i.astype(jnp.float32), ok

    def step(self, key, x, lp0, lp_fn, beta, chain_params, scan_idx) -> StepOut:
        precond = self.preconditioner.build(
            jax.random.fold_in(key, 1000003), chain_params["std_devs"]
        )
        k_mom = jax.random.fold_in(key, 1000004)
        v0 = jax.random.normal(k_mom, x.shape, x.dtype)

        # initial forward and backward segments from the same position
        fx, fv, fw, fxmax, n1, ok1 = self._segment(
            jax.random.fold_in(key, 0), lp_fn, precond, x, v0, skip_first=False
        )
        bx, bv, bw, bxmax, n2, ok2 = self._segment(
            jax.random.fold_in(key, 1), lp_fn, precond, x, -v0, skip_first=True
        )
        wmax = jnp.maximum(fw, bw)
        pos = jnp.where(fw > bw, fxmax, bxmax)
        valid = ok1 & ok2
        n_steps = n1 + n2

        # K more segments continuing a randomly chosen endpoint
        def seg(k_idx, carry):
            fx, fv, bx, bv, wmax, pos, valid, n_steps = carry
            kk = jax.random.fold_in(key, 2 + k_idx)
            go_fwd = jax.random.bernoulli(jax.random.fold_in(kk, 1000005))
            sx = jnp.where(go_fwd, fx, bx)
            sv = jnp.where(go_fwd, fv, bv)
            ex, ev, w, xm, n, ok = self._segment(
                kk, lp_fn, precond, sx, sv, skip_first=False
            )
            better = valid & ok & (w > wmax)
            wmax = jnp.where(better, w, wmax)
            pos = jnp.where(better, xm, pos)
            fx = jnp.where(go_fwd & ok, ex, fx)
            fv = jnp.where(go_fwd & ok, ev, fv)
            bx = jnp.where(~go_fwd & ok, ex, bx)
            bv = jnp.where(~go_fwd & ok, ev, bv)
            return fx, fv, bx, bv, wmax, pos, valid & ok, n_steps + n

        fx, fv, bx, bv, wmax, pos, valid, n_steps = lax.fori_loop(
            0, self.K, seg, (fx, fv, bx, bv, wmax, pos, valid, n_steps)
        )

        x_new = jnp.where(valid, pos, x)
        lp_new = jnp.where(valid, lp_fn(pos), lp0)
        z = jnp.zeros((), jnp.float32)
        return StepOut(x_new, lp_new, z, z, n_steps)
