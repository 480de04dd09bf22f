"""Coordinate-wise slice sampler (Neal 2003) with doubling + shrinking.

Reference semantics: ``src/explorers/SliceSampler.jl`` — per coordinate:
vertical draw z = lp - Exp(1); doubling scheme expanding the bracket at most
``p`` times (``slice_double``, ``:97-126``); shrinkage with the doubling
validity check (``slice_accept``, ``:192-237``); the log potential is cached
between coordinate moves (``:24-30``). Defaults w=10, p=20, n_passes=3,
max_iter=1024 (``:8-20``).

Batched design. The runtime vmaps ``step`` over ~10^4 replica lanes, so the
shape of the control flow decides the memory traffic per batched iteration:

  * The per-coordinate work is ONE flat ``lax.while_loop`` state machine
    (phases DOUBLE / SHRINK / CHECK) performing exactly one log-density
    evaluation per iteration, instead of nested loops (doubling loop, then a
    shrink loop with a validity-check loop inside every draw). Under vmap a
    while loop runs until the worst lane finishes, so nesting multiplies
    worst-lane tails; flattening pays the worst lane only once per coordinate.
  * The state vector ``x`` is NOT carried through the while loop — it is a
    loop invariant (a coordinate only commits on acceptance, after the loop).
    Batched-while predication copies every carried array each iteration, so
    carrying ``x`` would move an extra O(B·d) of HBM traffic per evaluation;
    the carry here is a handful of per-lane scalars.
  * The coordinate index is the (unbatched) fori counter, shared by all
    lanes, so candidate evaluation is a cheap shared-index
    dynamic-update-slice feeding the log density — XLA fuses it into the
    density's reduction — never a per-lane scatter.

Matching the reference: unlike the serial reference, the validity check
refreshes endpoint log densities eagerly each halving step (one eval per
iteration): under vmap the lazy-staleness bookkeeping buys nothing, since
masked lanes execute anyway.

Mixed coordinate types: ``integer_mask`` marks ordinal (integer-valued)
coordinates, handled with the reference's integer conventions
(``SliceSampler.jl:136-142,189``): the initial window is
``L = old - Uniform{0..w}``, ``R = L + w`` (``w`` must be a whole number),
and shrink candidates draw uniformly from the INCLUSIVE integer range
``{Lb..Rb}``. States stay float arrays carrying whole values — the density
sees floats holding integers, like the reference's typed state vector.

``binary_mask`` marks Bool coordinates, routed IN-SAMPLER to the exact
full-conditional Gibbs draw (reference ``SliceSampler.jl:65-86`` special-
cases Bools the same way): p(x_c = 1 | rest) from one extra density
evaluation, no slicing. Mixed Bool+continuous models therefore run under
the default explorer with no manual ``Compose``. The routing is a real
``lax.cond`` even under vmap: the coordinate index is the shared
(unbatched) fori counter, so the predicate is uniform across lanes and
only one branch executes per coordinate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .base import Explorer, StepOut

# phases of the per-coordinate machine
DOUBLE, SHRINK, CHECK, STOP = range(4)


class SliceSampler(Explorer):
    def __init__(self, w: float = 10.0, p: int = 20, n_passes: int = 3,
                 max_iter: int = 1024, integer_mask=None, binary_mask=None):
        self.w = float(w)
        self.p = int(p)
        self.n_passes = int(n_passes)
        self.max_iter = int(max_iter)
        if integer_mask is not None:
            integer_mask = np.asarray(integer_mask, bool)
            if integer_mask.any() and self.w != round(self.w):
                # reference: "for integer variables, the width should be an
                # integer" (SliceSampler.jl:138)
                raise ValueError(
                    f"integer coordinates need a whole-number slice width; got w={self.w}"
                )
        self.integer_mask = integer_mask
        if binary_mask is not None:
            binary_mask = np.asarray(binary_mask, bool)
            if integer_mask is not None and (binary_mask & integer_mask).any():
                raise ValueError("a coordinate cannot be both binary and integer")
        self.binary_mask = binary_mask

    def step(self, key, x, lp0, lp_fn, beta, chain_params, scan_idx) -> StepOut:
        d = x.shape[0]
        f = lp0.dtype
        w = jnp.asarray(self.w, f)
        rtol = jnp.asarray(3.5e-4 if f == jnp.float32 else 1.5e-8, f)
        int_mask = (
            jnp.asarray(self.integer_mask)
            if self.integer_mask is not None
            else None
        )
        bin_mask = (
            jnp.asarray(self.binary_mask)
            if self.binary_mask is not None
            else None
        )

        def coord_step(i, carry):
            x, lp_cur, acc_sum, acc_n, n_evals = carry
            c = i % d
            k_c = jax.random.fold_in(key, i)
            is_int = int_mask[c] if int_mask is not None else jnp.asarray(False)

            def lp_at(v):
                return lp_fn(x.at[c].set(v))

            old = x[c]

            def gibbs_coord(carry):
                """Exact full-conditional draw for a Bool coordinate
                (reference ``SliceSampler.jl:65-86``): one extra density
                evaluation at the flipped value; ``lp_cur`` caches the
                current one."""
                x, lp_cur, acc_sum, acc_n, n_evals = carry
                lp_other = lp_at(1.0 - old)
                is_one = old > 0.5
                lp1 = jnp.where(is_one, lp_cur, lp_other)
                lp0v = jnp.where(is_one, lp_other, lp_cur)
                p_zero = 1.0 / (1.0 + jnp.exp(lp1 - lp0v))
                u = jax.random.uniform(jax.random.fold_in(k_c, 0), dtype=f)
                new = jnp.where(u < p_zero, 0.0, 1.0).astype(x.dtype)
                return (
                    x.at[c].set(new),
                    jnp.where(new == old, lp_cur, lp_other),
                    acc_sum + 1.0,
                    acc_n + 1.0,
                    n_evals + 1.0,
                )

            def slice_coord(carry):
                x, lp_cur, acc_sum, acc_n, n_evals = carry
                return _slice_body(
                    x, lp_cur, acc_sum, acc_n, n_evals, c, k_c, is_int, old,
                    lp_at,
                )

            if bin_mask is None:
                return slice_coord(carry)
            # the coordinate index is the shared fori counter, so the
            # predicate is uniform across vmap lanes: a real branch, the
            # slice machine never runs for binary coordinates
            return lax.cond(bin_mask[c], gibbs_coord, slice_coord, carry)

        def _slice_body(x, lp_cur, acc_sum, acc_n, n_evals, c, k_c, is_int,
                        old, lp_at):
            z = lp_cur - jax.random.exponential(jax.random.fold_in(k_c, 0), dtype=f)
            u_init = jax.random.uniform(jax.random.fold_in(k_c, 1), dtype=f)
            # integer coords: L = old - Uniform{0..w} (inclusive), R = L + w
            L0 = jnp.where(
                is_int,
                old - jnp.floor(u_init * (w + 1.0)),
                old - w * u_init,
            )
            R0 = L0 + w
            lpL0 = lp_at(L0)
            lpR0 = lp_at(R0)

            phase0 = jnp.where(
                (self.p > 0) & ((z < lpL0) | (z < lpR0)), DOUBLE, SHRINK
            ).astype(jnp.int32)
            fz = jnp.zeros((), f)
            i0 = jnp.zeros((), jnp.int32)
            f32z = jnp.zeros((), jnp.float32)
            # carry: (phase, it, L, R, lpL, lpR, K, Lb, Rb, cand, lp_cand,
            #         Lh, Rh, lpLh, lpRh, n_shr, accepted, considered, evals)
            init = (phase0, i0, L0, R0, lpL0, lpR0, jnp.asarray(self.p, jnp.int32),
                    L0, R0, old, lp_cur, fz, fz, fz, fz, i0,
                    jnp.asarray(False), f32z, f32z)

            def cond(st):
                return st[0] != STOP

            def body(st):
                (phase, it, L, R, lpL, lpR, K, Lb, Rb, cand, lp_cand,
                 Lh, Rh, lpLh, lpRh, n_shr, accepted, considered, evals) = st

                k_it = jax.random.fold_in(k_c, 2 + it)
                u_side = jax.random.uniform(jax.random.fold_in(k_it, 0), dtype=f)
                u_shr = jax.random.uniform(jax.random.fold_in(k_it, 1), dtype=f)

                # the one evaluation point of this iteration
                grow_left = u_side <= 0.5
                span = R - L
                dbl_q = jnp.where(grow_left, L - span, R + span)
                # integer coords draw uniformly over the INCLUSIVE range
                # {Lb..Rb} (reference draw_new_position, SliceSampler.jl:189)
                cand_draw = jnp.where(
                    is_int,
                    Lb + jnp.floor(u_shr * (Rb - Lb + 1.0)),
                    Lb + u_shr * (Rb - Lb),
                )
                M = 0.5 * (Lh + Rh)
                query = lax.select_n(phase, dbl_q, cand_draw, M, old)
                lp_q = lp_at(query)
                evals = evals + jnp.where(phase != STOP, 1.0, 0.0).astype(jnp.float32)

                # DOUBLE: commit the grown side; continue while an endpoint
                # is inside the slice and the budget lasts
                ph_dbl = phase == DOUBLE
                L = jnp.where(ph_dbl & grow_left, dbl_q, L)
                R = jnp.where(ph_dbl & ~grow_left, dbl_q, R)
                lpL = jnp.where(ph_dbl & grow_left, lp_q, lpL)
                lpR = jnp.where(ph_dbl & ~grow_left, lp_q, lpR)
                K = jnp.where(ph_dbl, K - 1, K)
                more_dbl = (K > 0) & ((z < lpL) | (z < lpR))
                start_shrink = ph_dbl & ~more_dbl
                Lb = jnp.where(start_shrink, L, Lb)
                Rb = jnp.where(start_shrink, R, Rb)

                # SHRINK: vertical test; maybe start the validity check
                ph_shr = phase == SHRINK
                cand = jnp.where(ph_shr, cand_draw, cand)
                lp_cand = jnp.where(ph_shr, lp_q, lp_cand)
                n_shr = jnp.where(ph_shr, n_shr + 1, n_shr)
                consider = ph_shr & (z < lp_q)
                considered = considered + jnp.where(consider, 1.0, 0.0)
                narrow = (R - L) <= 1.1 * w  # doubling never ran: check vacuous
                accept_shr = consider & narrow
                to_check = consider & ~narrow
                Lh = jnp.where(to_check, L, Lh)
                Rh = jnp.where(to_check, R, Rh)
                lpLh = jnp.where(to_check, lpL, lpLh)
                lpRh = jnp.where(to_check, lpR, lpRh)

                # CHECK: halve toward the candidate (slice_accept)
                ph_chk = phase == CHECK
                take_left = cand < M
                crossed = (old < M) ^ take_left
                Lh = jnp.where(ph_chk & ~take_left, M, Lh)
                Rh = jnp.where(ph_chk & take_left, M, Rh)
                lpLh = jnp.where(ph_chk & ~take_left, lp_q, lpLh)
                lpRh = jnp.where(ph_chk & take_left, lp_q, lpRh)
                chk_rej = ph_chk & crossed & (z >= lpLh) & (z >= lpRh)
                chk_more = ph_chk & ~chk_rej & ((Rh - Lh) > 1.1 * w)
                accept_chk = ph_chk & ~chk_rej & ~chk_more

                # rejected candidates shrink the bracket toward themselves
                rejected = (ph_shr & ~consider) | chk_rej
                shrink_left = cand < old
                Lb = jnp.where(rejected & shrink_left, cand, Lb)
                Rb = jnp.where(rejected & ~shrink_left, cand, Rb)
                degenerate = jnp.where(
                    is_int,
                    (Rb - Lb) < 0.5,  # single remaining integer candidate
                    jnp.abs(Rb - Lb)
                    <= rtol * jnp.maximum(jnp.abs(Lb), jnp.abs(Rb)),
                )
                bail = rejected & (degenerate | (n_shr >= self.max_iter))

                accepted = accepted | accept_shr | accept_chk
                stop = accept_shr | accept_chk | bail
                phase = jnp.asarray(
                    jnp.where(
                        stop,
                        STOP,
                        jnp.where(
                            more_dbl & ph_dbl,
                            DOUBLE,
                            jnp.where(
                                start_shrink | (rejected & ~bail),
                                SHRINK,
                                jnp.where(to_check | chk_more, CHECK, phase),
                            ),
                        ),
                    ),
                    jnp.int32,
                )
                return (phase, it + 1, L, R, lpL, lpR, K, Lb, Rb, cand, lp_cand,
                        Lh, Rh, lpLh, lpRh, n_shr, accepted, considered, evals)

            st = lax.while_loop(cond, body, init)
            accepted, considered, evals = st[16], st[17], st[18]
            cand, lp_cand = st[9], st[10]

            # commit: a single shared-index column write per coordinate
            x = x.at[c].set(jnp.where(accepted, cand, old))
            lp_cur = jnp.where(accepted, lp_cand, lp_cur)
            return (
                x,
                lp_cur,
                acc_sum + jnp.where(accepted, 1.0, 0.0),
                acc_n + considered,
                n_evals + 2.0 + evals,
            )

        z32 = jnp.zeros((), jnp.float32)
        x, lp, acc_sum, acc_n, n_evals = lax.fori_loop(
            0, self.n_passes * d, coord_step, (x, lp0, z32, z32, z32)
        )
        return StepOut(x, lp, acc_sum, acc_n, n_evals)
