"""Batched coordinate-wise slice sampler for separable densities.

Same algorithm as :class:`~pigeons_tpu.ops.SliceSampler` (Neal 2003 doubling
+ shrinking + validity check; reference ``src/explorers/SliceSampler.jl``),
run over the whole replica batch at once when the density is additively
separable (the ``coord_log_density`` contract). For such a density the
coordinate-c slice test ``z < lp(x with v at c)`` with ``z = lp(x) - Exp``
reduces to ``f_c(x_c) - Exp < f_c(v)``: every other coordinate's contribution
cancels from both sides. The coordinate updates are therefore mutually
independent, and the sequential Gibbs sweep of the reference
(``src/explorers/SliceSampler.jl:43-62``) factorizes into ``dim``
independent 1-D slice samplers with the same stationary law. Every
``(coordinate, lane)`` element runs its own state machine (``_sweep``) and
chains its ``n_passes`` passes without synchronizing with any other element.

``_sweep`` is written once, as a pure function over arrays, and built two
ways:

* ``_sweep_pallas`` — a Pallas kernel through Triton. The grid covers
  (lane blocks, coordinate-row blocks), both parallel; each block keeps its
  tile's machines in registers for the whole loop and stops at its own
  slowest element. Per-block stats partials are summed by XLA.
* ``_sweep_plain`` — the same function over the whole ``[B, dim]`` plane in
  one ``lax.while_loop``. It is the kernel's reference, and the path on a
  CPU backend.

Randomness is counter-based: every draw is a pure function of (two uint32
key words of the lane's global-index key, global coordinate row, iteration)
through murmur3's integer finalizer, never of the device index or the block
decomposition. Both builds therefore draw the same streams, and a chain- or
replicate-sharded run is bitwise identical to its single-device twin — the
kernel analogue of the reference's parallelism invariance
(``docs/src/distributed.md:39-44``). The streams differ from the XLA
sampler's (different mixer and draw order), so runs are deterministic and
layout-invariant per implementation, not bitwise equal across them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .base import StepOut
from .slice_sampler import SliceSampler

ENTER, DOUBLE, SHRINK, CHECK, DONE = range(5)

# One block is one warp with one element per thread. Blocks wait for their
# own slowest element, so the smallest block wins: on an H100 (400 W limit)
# a 32-element tile on one warp ran a config-1 sweep in 0.88 ms, 256
# elements on 4 warps in 1.15 ms, and 16 elements per thread spill
# registers (14.8 ms).
_NUM_WARPS = 1
_TILE = (32, 1)  # (lanes, coordinate rows), powers of two as Triton requires


def _fmix32(h):
    """murmur3's 32-bit finalizer: a full-avalanche bijection of uint32."""
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> jnp.uint32(16))
    return h


def _element_key(w0, row):
    """Per-element key word: a bijection of the lane word ``w0`` for each
    global coordinate row, so the rows of one lane never share a stream."""
    return _fmix32(w0 ^ _fmix32(row.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)))


def _uniform(ka, kb, ctr):
    """(0, 1) float32 draw number ``ctr`` of the element keyed (ka, kb).

    The counter is mixed on its own first (a scalar), so two elements' streams
    can never be shifted copies of each other; ``ka`` and ``kb`` then enter
    through two bijective rounds, so two streams coincide only if both 32-bit
    words do (64 bits of lane entropy instead of 32)."""
    c = _fmix32(ctr ^ jnp.uint32(0x7F4A7C15))
    bits = _fmix32(_fmix32(ka ^ c) ^ kb)
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
        2.0**-24
    ) + jnp.float32(2.0**-25)


def _sweep(x, lane, row, betas, isvars, w0, w1, coord_vals, consts,
           ceval_fn, n_lanes, dim, *, w, p_dbl, n_passes, max_iter):
    """Run every element's ``n_passes`` 1-D slice updates to completion.

    ``x`` holds the coordinate values of a kernel tile or of the whole
    plane, lanes on axis 0; ``lane``/``row`` are each element's global lane
    and coordinate indices. Per-lane inputs (``betas``, ``isvars``, key
    words ``w0``/``w1``) are ``[., 1]`` columns and ``coord_vals`` ``[1, .]``
    rows, broadcast here. Elements past ``n_lanes`` lanes or ``dim`` rows
    are padding and start DONE. Returns the new values and the per-element
    acceptance sum, candidate count and density-query count (float32).
    """
    bc = lambda a: jnp.broadcast_to(a, x.shape)
    beta, isvar = bc(betas), bc(isvars)
    cvals = [bc(c) for c in coord_vals]
    ka, kb = _element_key(bc(w0), row), bc(w1)
    live = (row < dim) & (lane < n_lanes)

    def ceval(v):
        return ceval_fn(v, row, beta, isvar, consts, cvals)

    W = jnp.float32(w)
    fz = jnp.zeros(x.shape, jnp.float32)
    iz = jnp.zeros(x.shape, jnp.int32)
    phase0 = jnp.where(live, ENTER, DONE).astype(jnp.int32)

    # f32: x, z, L, R, lcL, lcR, Lb, Rb, cand, Lh, Rh, lcLh, lcRh,
    #      acc_sum, acc_n, n_evals;  i32: phase, pass_i, K, n_shr
    init = (x, fz, fz, fz, fz, fz, fz, fz, fz, fz, fz, fz, fz,
            fz, fz, fz, phase0, iz, iz, iz, jnp.uint32(0))

    def cond(st):
        return jnp.min(st[16]) < DONE

    def body(st):
        (old, z, L, R, lcL, lcR, Lb, Rb, cand, Lh, Rh, lcLh, lcRh,
         acc_sum, acc_n, n_evals, phase, pass_i, K, n_shr, it) = st

        uA = _uniform(ka, kb, it * jnp.uint32(2))
        uB = _uniform(ka, kb, it * jnp.uint32(2) + jnp.uint32(1))

        is_enter = phase == ENTER
        active = phase != DONE

        # until the accept commit, the element's value IS the pass's "old"
        L = jnp.where(is_enter, old - W * uA, L)
        R = jnp.where(is_enter, L + W, R)

        grow_left = uA <= 0.5
        span = R - L
        dbl_q = jnp.where(grow_left, L - span, R + span)
        cand_draw = Lb + uA * (Rb - Lb)
        M = 0.5 * (Lh + Rh)
        query = jnp.where(
            is_enter, R,
            jnp.where(phase == DOUBLE, dbl_q,
            jnp.where(phase == SHRINK, cand_draw,
            jnp.where(phase == CHECK, M, old))))

        # three elementwise density terms; ENTER consumes all of them (own
        # value for z, both endpoints), other phases only the query. Per the
        # reference's counting the current value's term is the cached eval.
        lp_q = ceval(query)
        lc_old = ceval(old)
        lc_L = ceval(L)
        n_evals = n_evals + jnp.where(is_enter, 2.0, 1.0) * active.astype(
            jnp.float32
        )

        z = jnp.where(is_enter, lc_old + jnp.log(uB), z)  # lc_old - Exp(1)
        lcL = jnp.where(is_enter, lc_L, lcL)
        lcR = jnp.where(is_enter, lp_q, lcR)  # query == R at ENTER
        K = jnp.where(is_enter, p_dbl, K)

        ph_dbl = phase == DOUBLE
        L = jnp.where(ph_dbl & grow_left, dbl_q, L)
        R = jnp.where(ph_dbl & ~grow_left, dbl_q, R)
        lcL = jnp.where(ph_dbl & grow_left, lp_q, lcL)
        lcR = jnp.where(ph_dbl & ~grow_left, lp_q, lcR)
        K = jnp.where(ph_dbl, K - 1, K)

        more_dbl = (K > 0) & ((z < lcL) | (z < lcR))
        start_shrink = (is_enter | ph_dbl) & ~more_dbl
        Lb = jnp.where(start_shrink, L, Lb)
        Rb = jnp.where(start_shrink, R, Rb)
        n_shr = jnp.where(start_shrink, 0, n_shr)

        ph_shr = phase == SHRINK
        cand = jnp.where(ph_shr, cand_draw, cand)
        n_shr = jnp.where(ph_shr, n_shr + 1, n_shr)
        consider = ph_shr & (z < lp_q)
        acc_n = acc_n + consider.astype(jnp.float32)
        narrow = (R - L) <= 1.1 * W  # doubling never ran: check is vacuous
        accept_shr = consider & narrow
        to_check = consider & ~narrow
        Lh = jnp.where(to_check, L, Lh)
        Rh = jnp.where(to_check, R, Rh)
        lcLh = jnp.where(to_check, lcL, lcLh)
        lcRh = jnp.where(to_check, lcR, lcRh)

        # CHECK: halve toward the candidate (slice_accept, eager refresh)
        ph_chk = phase == CHECK
        take_left = cand < M
        crossed = (old < M) ^ take_left
        Lh = jnp.where(ph_chk & ~take_left, M, Lh)
        Rh = jnp.where(ph_chk & take_left, M, Rh)
        lcLh = jnp.where(ph_chk & ~take_left, lp_q, lcLh)
        lcRh = jnp.where(ph_chk & take_left, lp_q, lcRh)
        chk_rej = ph_chk & crossed & (z >= lcLh) & (z >= lcRh)
        chk_more = ph_chk & ~chk_rej & ((Rh - Lh) > 1.1 * W)
        accept_chk = ph_chk & ~chk_rej & ~chk_more

        # rejected candidates shrink the bracket toward themselves
        rejected = (ph_shr & ~consider) | chk_rej
        shrink_left = cand < old
        Lb = jnp.where(rejected & shrink_left, cand, Lb)
        Rb = jnp.where(rejected & ~shrink_left, cand, Rb)
        degenerate = jnp.abs(Rb - Lb) <= 3.5e-4 * jnp.maximum(
            jnp.abs(Lb), jnp.abs(Rb)
        )
        bail = rejected & (degenerate | (n_shr >= max_iter))

        accepted = accept_shr | accept_chk
        finish = accepted | bail
        new = jnp.where(accepted, cand, old)
        acc_sum = acc_sum + accepted.astype(jnp.float32)

        pass_i = jnp.where(finish, pass_i + 1, pass_i)
        phase = jnp.where(
            finish,
            jnp.where(pass_i >= n_passes, DONE, ENTER),
            jnp.where((is_enter | ph_dbl) & more_dbl, DOUBLE,
            jnp.where(start_shrink | (rejected & ~bail), SHRINK,
            jnp.where(to_check | chk_more, CHECK, phase))),
        ).astype(jnp.int32)

        return (new, z, L, R, lcL, lcR, Lb, Rb, cand, Lh, Rh, lcLh, lcRh,
                acc_sum, acc_n, n_evals, phase, pass_i, K, n_shr,
                it + jnp.uint32(1))

    st = lax.while_loop(cond, body, init)
    return st[0], st[13], st[14], st[15]


def _sweep_plain(x, *args, **params):
    """``_sweep`` over the whole ``[B, dim]`` plane in one XLA while loop.
    Returns ``(x, [3, B] stats)``."""
    lane = lax.broadcasted_iota(jnp.int32, x.shape, 0)
    row = lax.broadcasted_iota(jnp.int32, x.shape, 1)
    x_new, *stats = _sweep(x, lane, row, *args, **params)
    return x_new, jnp.stack([jnp.sum(s, axis=1) for s in stats])


def _sweep_kernel(x_ref, beta_ref, isvar_ref, w0_ref, w1_ref, *refs,
                  n_consts, n_coord, const_shapes, ceval_fn, n_lanes, dim,
                  tile, params):
    const_refs = refs[:n_consts]
    coord_refs = refs[n_consts:n_consts + n_coord]
    xo_ref, acc_ref, accn_ref, ne_ref = refs[n_consts + n_coord:]
    lanes, rows = tile
    lane = pl.program_id(0) * lanes + lax.broadcasted_iota(jnp.int32, tile, 0)
    row = pl.program_id(1) * rows + lax.broadcasted_iota(jnp.int32, tile, 1)
    consts = [r[...].reshape(s) for r, s in zip(const_refs, const_shapes)]
    x_new, *stats = _sweep(
        x_ref[...], lane, row, beta_ref[...], isvar_ref[...], w0_ref[...],
        w1_ref[...], [r[...] for r in coord_refs], consts, ceval_fn,
        n_lanes, dim, **params,
    )
    xo_ref[...] = x_new
    for ref, s in zip((acc_ref, accn_ref, ne_ref), stats):
        ref[...] = jnp.sum(s, axis=1, keepdims=True)


def _sweep_pallas(x, betas, isvars, w0, w1, coord_vals, consts, ceval_fn,
                  n_lanes, dim, *, tile, interpret=False, **params):
    """``_sweep`` as a Pallas/Triton kernel over ``tile = (lanes, rows)``
    blocks of the ``[B, dim]`` plane, both padded to multiples of the tile.
    Returns ``(x, [3, B] stats)``."""
    lanes, rows = tile
    b_pad, d_pad = x.shape
    grid = (b_pad // lanes, d_pad // rows)
    # 0-d constants travel as [1] arrays (a kernel operand has a shape)
    consts1 = [c.reshape(c.shape or (1,)) for c in consts]

    def full(a):
        return pl.BlockSpec(a.shape, lambda i, g: (0,) * a.ndim)

    lane_spec = pl.BlockSpec((lanes, 1), lambda i, g: (i, 0))
    tile_spec = pl.BlockSpec(tile, lambda i, g: (i, g))
    kern = functools.partial(
        _sweep_kernel,
        n_consts=len(consts), n_coord=len(coord_vals),
        const_shapes=tuple(c.shape for c in consts), ceval_fn=ceval_fn,
        n_lanes=n_lanes, dim=dim, tile=tile, params=params,
    )
    # per-block stats partials, one column per coordinate-row block
    stat_shape = jax.ShapeDtypeStruct((b_pad, grid[1]), jnp.float32)
    stat_spec = pl.BlockSpec((lanes, 1), lambda i, g: (i, g))
    x_new, *partials = pl.pallas_call(
        kern,
        grid=grid,
        in_specs=[tile_spec]
        + [lane_spec] * 4
        + [full(c) for c in consts1]
        + [pl.BlockSpec((1, rows), lambda i, g: (0, g)) for _ in coord_vals],
        out_specs=[tile_spec] + [stat_spec] * 3,
        out_shape=[jax.ShapeDtypeStruct(x.shape, jnp.float32)]
        + [stat_shape] * 3,
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="slice_sweep",
    )(x, betas, isvars, w0, w1, *consts1, *coord_vals)
    return x_new, jnp.stack([jnp.sum(p, axis=1) for p in partials])


def _hoist(fn, *example):
    """Pallas kernels may not capture array constants (model data the density
    closes over): hoist the jaxpr consts into explicit kernel inputs
    (``jax.closure_convert`` only hoists tracers, not arrays)."""
    cj = jax.make_jaxpr(fn)(*example)
    n_args = len(example)

    def call(*args_and_consts):
        args = args_and_consts[:n_args]
        cs = args_and_consts[n_args:]
        return jax.core.eval_jaxpr(cj.jaxpr, cs, *args)[0]

    return call, list(cj.consts)


def batched_sweep(keys, xs, betas, isvars, coord_fn, coord_arrays=(), *,
                  w, p_dbl, n_passes, max_iter, impl, tile=_TILE):
    """One slice sweep of every (coordinate, lane) element of ``xs [B, dim]``.

    ``coord_fn(v, c, beta, isvar, *coord_vals) -> scalar`` is coordinate
    ``c``'s term of a separable density; ``coord_arrays`` are [dim] vectors
    whose entry ``c`` reaches it as ``coord_vals``. ``impl`` is ``"kernel"``
    (compiled Pallas/Triton), ``"interpret"`` (the same kernel in the Pallas
    interpreter) or ``"plain"`` (one XLA while loop). All three draw the same
    streams. Returns ``(x_new [B, dim], stats [3, B])``: acceptance sum,
    candidate count, density queries.
    """
    B, dim = xs.shape
    f0 = jnp.float32(0.0)
    closed, consts = _hoist(
        coord_fn, f0, jnp.int32(0), f0, f0, *(f0 for _ in coord_arrays)
    )

    def ceval_fn(v, row, beta, isvar, kconsts, cvals):
        def f(v, c, b, iv, *cv):
            return closed(v, c, b, iv, *cv, *kconsts)

        return jax.vmap(jax.vmap(f))(v, row, beta, isvar, *cvals)

    if impl == "plain":
        b_pad, d_pad = B, dim
    else:
        b_pad = -(-B // tile[0]) * tile[0]
        d_pad = -(-dim // tile[1]) * tile[1]

    def lane_col(a, dtype):
        return jnp.zeros((b_pad, 1), dtype).at[:B, 0].set(a.astype(dtype))

    # two uint32 words per lane from its global-index key
    words = jax.vmap(lambda k: jax.random.bits(k, (2,), jnp.uint32))(keys)
    # the plane stays [B, dim], lanes major, like the runtime's states: a
    # transposed layout would make the caller's density sums over the
    # coordinates column reductions, whose rounding depends on the batch size
    args = (
        jnp.zeros((b_pad, d_pad), jnp.float32).at[:B, :dim].set(xs),
        lane_col(betas, jnp.float32),
        lane_col(isvars, jnp.float32),
        lane_col(words[:, 0], jnp.uint32),
        lane_col(words[:, 1], jnp.uint32),
        [
            jnp.zeros((1, d_pad), jnp.float32).at[0, :dim].set(
                jnp.asarray(a, jnp.float32)
            )
            for a in coord_arrays
        ],
        consts,
        ceval_fn,
        B,
        dim,
    )
    params = dict(w=w, p_dbl=p_dbl, n_passes=n_passes, max_iter=max_iter)
    if impl == "plain":
        x_out, stats = _sweep_plain(*args, **params)
    elif impl in ("kernel", "interpret"):
        x_out, stats = _sweep_pallas(
            *args, tile=tile, interpret=impl == "interpret", **params
        )
    else:
        raise ValueError(f"unknown sweep impl {impl!r}")
    return x_out[:B, :dim], stats[:, :B]


class SliceSamplerPallas(SliceSampler):
    """Slice sampler with a batched path for separable densities.

    The runtime hands ``step_batched`` the whole replica batch. When the
    target gives ``coord_log_density``, every (coordinate, lane) element runs
    its own 1-D slice machine (:func:`batched_sweep`): compiled as a
    Pallas/Triton kernel on a GPU backend, as one XLA while loop elsewhere.
    Otherwise, and for integer or Bool coordinates, it runs the inherited XLA
    :class:`SliceSampler` step.

    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests).
    """

    def __init__(self, w: float = 10.0, p: int = 20, n_passes: int = 3,
                 max_iter: int = 1024, interpret: bool = False,
                 integer_mask=None, binary_mask=None):
        super().__init__(
            w=w, p=p, n_passes=n_passes, max_iter=max_iter,
            integer_mask=integer_mask, binary_mask=binary_mask,
        )
        self.interpret = bool(interpret)

    @property
    def batched(self) -> bool:
        # integer/ordinal and Bool coordinates run through the XLA sampler
        # (the batched path implements the continuous draw conventions only;
        # Bool coordinates need the in-sampler exact Gibbs draw)
        return self.integer_mask is None and self.binary_mask is None

    def sweep_impl(self) -> str:
        """The :func:`batched_sweep` build for this process's backend."""
        if self.interpret:
            return "interpret"
        return "kernel" if jax.default_backend() == "gpu" else "plain"

    def supports_ref_params(self, ref_params) -> bool:
        if ref_params == () or ref_params is None:
            return True
        # array-pytree reference params (e.g. the variational Gaussian's
        # mean/std/active) become ordinary kernel inputs
        leaves = jax.tree.leaves(ref_params)
        return bool(leaves) and all(hasattr(l, "shape") for l in leaves)

    def step_batched(self, keys, xs, lp0s, ld, betas, isvars, ref_params,
                     chain_params, scan_idx, ld_coord=None, coord_arrays=(),
                     compute_final_lp: bool = True) -> StepOut:
        """One sweep over the replica batch.

        ``keys [B]`` are the runtime's per-lane PRNG keys, derived by GLOBAL
        replica index (``rng.keys_for``); each is reduced to two uint32 words
        from which every draw is hashed, so the stream is bitwise
        layout-invariant across any device/block decomposition.
        ``xs [B, dim]``, ``lp0s/betas/isvars [B]``; ``ld(x, beta, isvar,
        ref_params) -> scalar`` is the traced interpolated log density.
        ``ld_coord(v, c, beta, isvar, ref_params, *coord_vals) -> scalar``,
        when given, is the contribution of coordinate ``c`` at value ``v`` of
        a separable density: each proposal is answered from it as an O(1)
        term instead of a full O(dim) recomputation (the reference's
        SliceSampler re-evaluates the full closure per proposal,
        ``src/explorers/SliceSampler.jl:144-186``). ``coord_arrays`` are
        [dim]-shaped per-coordinate parameter vectors (e.g. the variational
        Gaussian's mean/std): coordinate ``c``'s entries arrive as
        ``coord_vals`` scalars, delivered by the kernel's row blocks — the
        compiled kernel has no gather, so density closures must not index
        [dim] arrays by the traced ``c`` themselves.
        """
        if not self.supports_ref_params(ref_params):
            raise NotImplementedError(
                "SliceSamplerPallas.step_batched requires array-pytree "
                "reference params"
            )
        isvars = jnp.asarray(isvars, jnp.float32)
        if ld_coord is None:
            # non-separable density: the per-lane XLA sampler
            return jax.vmap(
                lambda k, x, lp0, b, iv, cp: self.step(
                    k, x, lp0, lambda xx: ld(xx, b, iv, ref_params), b, cp,
                    scan_idx,
                )
            )(keys, xs, lp0s, betas, isvars, chain_params)

        x_new, stats = batched_sweep(
            keys, xs, betas, isvars,
            lambda v, c, b, iv, *cv: ld_coord(v, c, b, iv, ref_params, *cv),
            tuple(coord_arrays),
            w=self.w, p_dbl=self.p, n_passes=self.n_passes,
            max_iter=self.max_iter, impl=self.sweep_impl(),
        )
        # the sweep never sees the joint density; recompute it in one fused
        # XLA pass — unless the caller computes it itself (the runtime fuses
        # it with the swap's partner-beta evaluation)
        if compute_final_lp:
            lp_new = jax.vmap(lambda xv, b, iv: ld(xv, b, iv, ref_params))(
                x_new, betas, isvars
            )
        else:
            # placeholder derived from the sweep's output so a data
            # dependency on the explorer survives even when the caller
            # discards lp (the host_sequential guard in pt.py sequences
            # host-callback density reads after the move through it)
            lp_new = x_new[:, 0] * 0.0
        return StepOut(
            x=x_new,
            lp=lp_new,
            accept_sum=stats[0],
            accept_n=stats[1],
            n_steps=stats[2],
        )
