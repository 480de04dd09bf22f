"""The PT runtime: rounds of (explore, communicate) scans with adaptation.

Reference call stack (``src/pt/pigeons.jl``): pigeons(pt) -> per round
run_one_round! (2^r scans of explore! then communicate!) -> reduce_recorders!
-> adapt (schedule via barrier estimation, explorer, variational) -> report ->
checkpoint. Round r performs 2^r scans (``src/pt/Iterators.jl:49``).

Structure: the whole round is ONE jitted ``lax.scan`` over scans.
Per scan:
  * explore: vmapped explorer kernel over the replica batch; the reference
    chain regenerates iid from the reference when available (blended with a
    ``where`` — reference ``pt/pigeons.jl:101-132`` branches per replica);
  * communicate: DEO swap as a permutation update (swaps.py);
  * recorders: fixed-shape accumulator updates in the carry.
Between rounds, tiny host-side numpy does barrier estimation / schedule
regridding / explorer adaptation — bitwise stable across device layouts.

States are indexed by replica and never move; the chain permutation is
replicated. Under a multi-device mesh, the states batch is sharded over the
replica axis and only per-replica scalars cross devices each scan.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import rng
from .adaptation import (
    CommunicationBarriers,
    communication_barriers,
    optimal_schedule,
    rejections_from_acceptance,
)
from .inputs import Inputs
from .recorders import (
    Recorders,
    ReducedRecorders,
    init_recorders,
    reduce_recorders,
    update_logsum,
    update_round_trips,
)
from .schedule import Schedule, equally_spaced_schedule
from .swaps import metropolis_accept_pr, swap_scan


def _make_round_kernel(
    path_log_density,  # (x, beta, is_var, ref_params) -> scalar
    sample_reference,  # (key, is_var, ref_params) -> x, or None
    explorer,
    accept_fn,
    n_chains: int,
    target_positions: tuple,  # static chain indices recording traces/moments
    extract_fn=None,  # (x, lp) -> trace vector; default appends lp to x
    extract_dim: int = 0,
    record_extended_traces: bool = False,  # per-scan extracts of ALL chains
    record_index_process: bool = False,
    record_swap_stats: bool = True,
    # Inputs.record gating: disabled recorders cost ZERO in the compiled
    # round (the accumulation code is never traced — the analogue of the
    # reference's @record_if_requested! being a no-op when the recorder is
    # absent, src/recorders/@record_if_requested!.jl:6-12)
    record_energy: bool = True,
    record_online: bool = True,
    record_round_trip: bool = True,
    record_traces: bool = True,
    use_iid_reference: bool = False,
    mesh=None,  # Optional[ReplicaMesh]: shard the replica axis when given
    n_replicates: int = 1,  # batch this many independent ladders
    use_batched_explorer: bool = False,  # hand the whole batch to the explorer
    ld_coord=None,  # (v, c, beta, is_var, ref_params, *coord_vals) -> scalar
    coord_arrays_fn=None,  # ref_params -> tuple of [dim] per-coordinate arrays
    host_sequential: bool = False,  # stateful host-evaluated density: sequence evals
    swap_graph=None,  # (n_chains, scan_idx) -> [N] partner map; default DEO
):
    """Build the jitted one-round kernel. Static configuration is closed over;
    everything that changes between rounds (betas, explorer state, reference
    params) is a dynamic argument so rounds of equal length share a trace.

    With a :class:`~pigeons_tpu.parallel.ReplicaMesh`, the whole round runs
    under ``shard_map``: states are block-partitioned over the replica axis,
    chain/replica permutations stay replicated, and each scan's only
    cross-device traffic is one ``all_gather`` of ``[N]`` swap scalars plus one
    ``psum`` of the ``[d+1]`` target-chain extract. Per-chain recorder partials
    (each chain written by exactly one device) are ``psum``-combined once at
    round end — bitwise identical to the single-device result because the sum
    only adds exact zeros (the analogue of the reference's deterministic
    reductions, ``mpi_utils/Entangler.jl:214-277``).
    """
    # two sharding modes over the same 1-D mesh: chain-axis sharding for one
    # big ladder (swap scalars all_gather each scan), or replicate-axis
    # sharding for n_replicates independent ladders (embarrassingly parallel —
    # no collectives at all; each device runs R/n_dev full ladders)
    if host_sequential and use_batched_explorer:
        # host callbacks cannot run inside a Pallas kernel, and the
        # callback-sequencing guard relies on the explorer's lp output
        raise ValueError(
            "batched (Pallas) explorers cannot drive host-evaluated targets; "
            "use the XLA explorer path"
        )
    if swap_graph is None:
        from .swaps import deo_partner_map as swap_graph
    shard_replicates = mesh is not None and n_replicates > 1
    axis = mesh.axis if (mesh is not None and not shard_replicates) else None
    n_dev = mesh.n_devices if mesh is not None else 1
    n_local = n_chains // n_dev if axis is not None else n_chains
    R_run = n_replicates // n_dev if shard_replicates else n_replicates

    def agather(x):
        return x if axis is None else jax.lax.all_gather(x, axis, tiled=True)

    def apsum(x):
        return x if axis is None else jax.lax.psum(x, axis)

    def ld(x, beta, isvar, ref_params):
        # NaN densities (outside-support evaluations) become -inf so the
        # kernels reject instead of freezing (reference log_potentials.jl
        # NaN guard; DynamicPPL ext DomainError -> -Inf)
        lp = path_log_density(x, beta, isvar, ref_params)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    v_ld = jax.vmap(ld, in_axes=(0, 0, 0, None))

    def ld2(x, b_own, iv_own, b_pt, iv_pt, ref_params):
        # own-beta and partner-beta densities of the SAME state in one traced
        # call: the endpoint densities ref(x)/target(x) are shared
        # subexpressions, so XLA computes them once — the swap's partner
        # evaluation is nearly free (the reference pays a full second
        # evaluation per swap, src/swap/pair_swapper.jl:42-47)
        return ld(x, b_own, iv_own, ref_params), ld(x, b_pt, iv_pt, ref_params)

    v_ld2 = jax.vmap(ld2, in_axes=(0, 0, 0, 0, 0, None))

    def _explore(
        states, chain_loc, lane_keys, lp_before, betas, is_var,
        exp_state, ref_params, scan_idx
    ):
        """Exploration over a (possibly replicate-flattened) replica batch.
        ``lane_keys`` are per-replica PRNG keys derived by GLOBAL replica
        index (layout-invariant, reference ``replicas.jl:87-98``); batched
        explorers receive the same per-lane keys and must keep their streams
        a pure function of them — never of the device index or block layout —
        so sharded runs stay bitwise identical to their serial twins.
        ``lp_before`` is carried through the scan (the post-swap density of
        the previous scan) instead of being recomputed."""
        betas_loc = betas[chain_loc]
        isvar_loc = is_var[chain_loc]
        chain_params = jax.tree.map(lambda a: a[chain_loc], exp_state)

        if use_batched_explorer:
            cv = coord_arrays_fn(ref_params) if coord_arrays_fn is not None else ()
            out = explorer.step_batched(
                lane_keys, states, lp_before, ld, betas_loc, isvar_loc,
                ref_params, chain_params, scan_idx, ld_coord=ld_coord,
                coord_arrays=cv, compute_final_lp=False,
            )
        else:
            def one_step(key, x, lp0, beta, isvar, cp):
                return explorer.step(
                    key, x, lp0, lambda xx: ld(xx, beta, isvar, ref_params),
                    beta, cp, scan_idx
                )

            out = jax.vmap(one_step)(
                lane_keys, states, lp_before, betas_loc, isvar_loc, chain_params
            )
        return out

    def _blend_iid_x(x_after, chain_loc, k_iid, keys_gidx, is_var, ref_mask,
                     ref_params):
        """Regenerate reference-chain states iid (state only; the density is
        picked up by the fused post-explore evaluation)."""
        n = n_chains
        is_ref_loc = ref_mask[chain_loc] & (n > 1)
        iid_keys = rng.keys_for(k_iid, keys_gidx)
        isvar_loc = is_var[chain_loc]
        iid = jax.vmap(lambda k, iv: sample_reference(k, iv, ref_params))(
            iid_keys, isvar_loc
        )
        return jnp.where(is_ref_loc[:, None], iid.astype(x_after.dtype), x_after)

    def post_one(
        x_after, lp_after, lp_partner, lp_before, stats, chain_of, replica_of,
        rec, master_key, round_idx, scan_idx, betas, is_var, ref_mask,
        target_mask, ref_params, gidx
    ):
        """Recorder updates + DEO swap for one ladder (or one device shard).
        ``lp_after``/``lp_partner`` are the fused own/partner-beta densities of
        ``x_after``; returns the carried post-swap density as well."""
        n = n_chains
        (accept_sum_e, accept_n_e, n_steps_e, extras_sum_e, extras_n_e) = stats
        chain_loc = chain_of[gidx]

        # Per-chain recorder updates. Each chain is held by exactly one
        # replica, so reordering rows into chain order is a permutation. On a
        # single device that is a plain gather by the chain->replica inverse
        # map (a gather is plain vector work, a scatter may serialize). Across a
        # mesh each device scatters its shard's rows into the [N, .] layout
        # and the psum adds only exact zeros — either way the accumulated
        # round totals are bitwise identical to the single-device run even
        # though chains migrate across devices (the analogue of the
        # reference's deterministic reductions, Entangler.jl:214-277).
        n_extras = len(explorer.extra_names)
        row_parts = []
        if record_energy:
            row_parts.append(
                jnp.stack(
                    [
                        jnp.ones_like(lp_before),
                        lp_before,
                        lp_after,
                        lp_before**2,
                        lp_after**2,
                        lp_before * lp_after,
                    ],
                    axis=-1,
                )
            )
        row_parts += [
            accept_sum_e[:, None],
            accept_n_e[:, None],
            n_steps_e[:, None],
        ]
        if n_extras:
            row_parts += [extras_sum_e, extras_n_e]
        rows = jnp.concatenate(row_parts, axis=1)  # [n_local, (6+)3 + 2K]
        if axis is None:
            chain_update = rows[replica_of]  # permutation gather
        else:
            chain_update = apsum(
                jnp.zeros((n, rows.shape[1]), rows.dtype).at[chain_loc].add(rows)
            )
        from .recorders import kadd

        off = 6 if record_energy else 0
        if record_energy:
            rec = rec._replace(energy=kadd(rec.energy, chain_update[:, :6]))
        rec = rec._replace(
            exp_accept_sum=kadd(rec.exp_accept_sum, chain_update[:, off]),
            exp_accept_n=kadd(rec.exp_accept_n, chain_update[:, off + 1]),
            exp_steps=kadd(rec.exp_steps, chain_update[:, off + 2]),
        )
        if n_extras:
            rec = rec._replace(
                extra_sum=kadd(
                    rec.extra_sum, chain_update[:, off + 3 : off + 3 + n_extras]
                ),
                extra_n=kadd(rec.extra_n, chain_update[:, off + 3 + n_extras :]),
            )

        # online moments + trace at the target chain(s) (reference
        # pigeons.jl:110-131; both leg targets record under 2-leg PT). On a
        # single device: gather the target replicas directly; across a mesh:
        # exactly one replica globally sits at each target chain, so the psum
        # of the masked local sum reconstructs its extract bit-for-bit.
        extract_loc = None
        extract = None
        if record_online or record_traces:
            if axis is None:
                tpos = jnp.asarray(target_positions)
                ridx = replica_of[tpos]
                extract = jax.vmap(extract_fn)(x_after[ridx], lp_after[ridx])
            else:
                extract_loc = jax.vmap(extract_fn)(x_after, lp_after)
                extracts = []
                for tc in target_positions:
                    at_tc = chain_loc == tc
                    extracts.append(
                        apsum(
                            jnp.sum(
                                jnp.where(at_tc[:, None], extract_loc, 0.0), axis=0
                            )
                        )
                    )
                extract = jnp.stack(extracts)  # [T, d+1]
        if record_online:
            rec = rec._replace(
                online_n=kadd(rec.online_n, float(len(target_positions))),
                online_sum=kadd(rec.online_sum, jnp.sum(extract, axis=0)),
                online_sumsq=kadd(rec.online_sumsq, jnp.sum(extract**2, axis=0)),
            )

        # ---------------- communicate ----------------
        # round-trip + index process recorded with the PRE-swap chain
        # (reference swap.jl:106-126); replicated [N] computation
        if record_round_trip:
            is_ref_all = ref_mask[chain_of] & (n > 1)
            is_target_all = target_mask[chain_of]
            rec = update_round_trips(rec, is_ref_all, is_target_all)

        log_ratio = agather(lp_partner - lp_after)  # [N] in global replica order

        k_swap = rng.scan_key(master_key, round_idx, scan_idx, rng.SWAP_UNIFORM)
        partner_map = swap_graph(n_chains, scan_idx)
        res = swap_scan(
            k_swap, scan_idx, chain_of, replica_of, log_ratio, accept_fn,
            partner_map=partner_map,
        )

        rec = rec._replace(
            accept_sum=kadd(
                rec.accept_sum, jnp.where(res.pair_active, res.accept_pr, 0.0)
            ),
            accept_n=kadd(rec.accept_n, res.pair_active.astype(jnp.float32)),
        )
        if record_swap_stats:
            lsr_fwd, lsr_fwd_n = update_logsum(
                rec.lsr_fwd, rec.lsr_fwd_n, res.ratio_fwd, res.pair_active
            )
            lsr_bwd, lsr_bwd_n = update_logsum(
                rec.lsr_bwd, rec.lsr_bwd_n, res.ratio_bwd, res.pair_active
            )
            rec = rec._replace(
                lsr_fwd=lsr_fwd, lsr_fwd_n=lsr_fwd_n, lsr_bwd=lsr_bwd, lsr_bwd_n=lsr_bwd_n
            )

        # carried density: a swapped replica's new own-beta density IS the
        # partner-beta density it just computed — the next scan's lp_before
        # costs nothing (the reference re-evaluates, pt/pigeons.jl:103)
        swapped = res.chain_of[gidx] != chain_loc
        lp_next = jnp.where(swapped, lp_partner, lp_after)

        outputs = {}
        if record_traces:
            outputs["trace"] = extract
        if record_extended_traces:
            # all chains' extracts in chain order (reference extended_traces,
            # Inputs.jl:95-101); one [N, d+1] all_gather per scan under a mesh
            if extract_loc is None:
                extract_loc = jax.vmap(extract_fn)(x_after, lp_after)
            outputs["extended_trace"] = agather(extract_loc)[replica_of, :]
        if record_index_process:
            outputs["index_process"] = chain_of

        return (x_after, res.chain_of, res.replica_of, lp_next, rec), outputs

    def _fused_post_densities(x_after, chain_loc, partner_map, betas, is_var,
                              ref_params, lp_guard=None):
        """Own-beta + partner-beta densities of the post-explore states in ONE
        fused pass (shared endpoint densities).

        ``lp_guard``: for stateful host-evaluated densities (stream workers,
        reference ``targets/StreamTarget.jl``), the density callback ignores
        ``x`` (the worker owns the state), so XLA sees no data dependency
        between the explorer's ``call_sampler!`` callback and these reads and
        may reorder them. Adding an exact zero derived from the explorer's
        output to the beta operands sequences every read after the move."""
        partner_loc = partner_map[chain_loc]
        b_own, b_pt = betas[chain_loc], betas[partner_loc]
        if lp_guard is not None:
            z = jnp.nan_to_num(lp_guard, nan=0.0, posinf=0.0, neginf=0.0) * 0.0
            b_own = b_own + z
            b_pt = b_pt + z
        return v_ld2(
            x_after, b_own, is_var[chain_loc], b_pt, is_var[partner_loc],
            ref_params,
        )

    def scan_body(
        carry, scan_idx, master_key, round_idx, betas, is_var, ref_mask, target_mask,
        exp_state, ref_params, gidx
    ):
        """One scan of a single ladder (optionally a device shard of one)."""
        states, chain_of, replica_of, lp_cur, rec = carry
        chain_loc = chain_of[gidx]
        k_explore = rng.scan_key(master_key, round_idx, scan_idx, rng.EXPLORE)
        k_iid = rng.scan_key(master_key, round_idx, scan_idx, rng.IID)
        out = _explore(
            states, chain_loc, rng.keys_for(k_explore, gidx), lp_cur, betas,
            is_var, exp_state, ref_params, scan_idx
        )
        x_after = out.x.astype(states.dtype)
        if use_iid_reference:
            x_after = _blend_iid_x(
                x_after, chain_loc, k_iid, gidx, is_var, ref_mask, ref_params
            )
        lp_after, lp_partner = _fused_post_densities(
            x_after, chain_loc, swap_graph(n_chains, scan_idx), betas, is_var,
            ref_params, lp_guard=out.lp if host_sequential else None,
        )
        stats = (out.accept_sum, out.accept_n, out.n_steps, out.extras_sum, out.extras_n)
        return post_one(
            x_after, lp_after, lp_partner, lp_cur, stats, chain_of, replica_of,
            rec, master_key, round_idx, scan_idx, betas, is_var, ref_mask,
            target_mask, ref_params, gidx
        )

    def scan_body_flat(
        carry, scan_idx, master_keys, round_idx, betas, is_var, ref_mask,
        target_mask, exp_state, ref_params
    ):
        """One scan of ``n_replicates`` independent ladders, exploration run as
        ONE flat batch of R*N lanes (so batched explorers — pallas kernels —
        see the whole batch), swaps/recorders vmapped per ladder. RNG streams
        match the per-ladder formulation: replicate r uses keys derived from
        ``master_keys[r]`` exactly as a standalone run with that key would."""
        R, n = R_run, n_chains
        states, chain_of, replica_of, lp_cur, rec = carry  # [R*n, .], [R, n]
        chain_flat = chain_of.reshape(-1)
        gidx = jnp.arange(n)

        k_explore_r = jax.vmap(
            lambda k: rng.scan_key(k, round_idx, scan_idx, rng.EXPLORE)
        )(master_keys)
        k_iid_r = jax.vmap(
            lambda k: rng.scan_key(k, round_idx, scan_idx, rng.IID)
        )(master_keys)
        # per-lane keys exactly as each standalone per-ladder run derives
        # them (keys_for over the ladder's own scan key) — batched explorers
        # included, so flat-batch AND sharded runs match the per-ladder
        # formulation's streams
        keys = jax.vmap(lambda k: rng.keys_for(k, gidx))(k_explore_r)
        flat_keys = keys.reshape((R * n,) + keys.shape[2:])
        out = _explore(
            states, chain_flat, flat_keys, lp_cur, betas,
            is_var, exp_state, ref_params, scan_idx
        )
        x_after = out.x.astype(states.dtype)
        if use_iid_reference:
            iid_keys = jax.vmap(lambda k: rng.keys_for(k, gidx))(k_iid_r)
            is_ref_loc = ref_mask[chain_flat] & (n > 1)
            isvar_loc = is_var[chain_flat]
            iid = jax.vmap(lambda k, iv: sample_reference(k, iv, ref_params))(
                iid_keys.reshape((R * n,) + iid_keys.shape[2:]), isvar_loc
            )
            x_after = jnp.where(is_ref_loc[:, None], iid.astype(x_after.dtype), x_after)

        lp_after, lp_partner = _fused_post_densities(
            x_after, chain_flat, swap_graph(n_chains, scan_idx), betas, is_var,
            ref_params, lp_guard=out.lp if host_sequential else None,
        )

        stats = (out.accept_sum, out.accept_n, out.n_steps, out.extras_sum, out.extras_n)
        d = states.shape[-1]

        def per_rep(a):
            return a.reshape((R, n) + a.shape[1:])

        def post_r(mk, xa, lpa, lpp, lpb, st, co, ro, rc):
            return post_one(
                xa, lpa, lpp, lpb, st, co, ro, rc, mk, round_idx, scan_idx,
                betas, is_var, ref_mask, target_mask, ref_params, gidx
            )

        stats_r = jax.tree.map(
            lambda a: per_rep(a) if hasattr(a, "shape") and a.ndim else a, stats
        )
        (xa, co, ro, lp_next, rec), outputs = jax.vmap(post_r)(
            master_keys, per_rep(x_after), per_rep(lp_after), per_rep(lp_partner),
            per_rep(lp_cur), stats_r, chain_of, replica_of, rec
        )
        return (xa.reshape(R * n, d), co, ro, lp_next.reshape(R * n), rec), outputs

    def run_round(
        master_key, round_idx, ladder, states, chain_of, replica_of, exp_state, ref_params, n_scans
    ):
        if axis is None:
            gidx = jnp.arange(n_local)
        else:
            dev = jax.lax.axis_index(axis)
            gidx = dev * n_local + jnp.arange(n_local)
        rec = init_recorders(n_chains, extract_dim, len(explorer.extra_names))
        betas, is_var = ladder["betas"], ladder["is_var"]
        if n_replicates > 1:
            rec = jax.tree.map(
                lambda a: jnp.broadcast_to(a, (R_run,) + a.shape), rec
            )
            body = partial(
                scan_body_flat,
                master_keys=master_key,
                round_idx=round_idx,
                betas=betas,
                is_var=is_var,
                ref_mask=ladder["ref_mask"],
                target_mask=ladder["target_mask"],
                exp_state=exp_state,
                ref_params=ref_params,
            )
            d = states.shape[-1]
            flat = states.reshape(R_run * n_chains, d)
            chain_flat = chain_of.reshape(-1)
            lp0 = v_ld(flat, betas[chain_flat], is_var[chain_flat], ref_params)
            (flat, chain_of, replica_of, _, rec), outputs = jax.lax.scan(
                body, (flat, chain_of, replica_of, lp0, rec),
                jnp.arange(1, n_scans + 1),
            )
            states = flat.reshape(R_run, n_chains, d)
            return states, chain_of, replica_of, rec, outputs
        body = partial(
            scan_body,
            master_key=master_key,
            round_idx=round_idx,
            betas=betas,
            is_var=is_var,
            ref_mask=ladder["ref_mask"],
            target_mask=ladder["target_mask"],
            exp_state=exp_state,
            ref_params=ref_params,
            gidx=gidx,
        )
        chain_loc0 = chain_of[gidx]
        lp0 = v_ld(states, betas[chain_loc0], is_var[chain_loc0], ref_params)
        (states, chain_of, replica_of, _, rec), outputs = jax.lax.scan(
            body, (states, chain_of, replica_of, lp0, rec),
            jnp.arange(1, n_scans + 1),
        )
        return states, chain_of, replica_of, rec, outputs

    @partial(jax.jit, static_argnames=("n_scans",))
    def round_kernel(
        master_key, round_idx, ladder, states, chain_of, replica_of, exp_state, ref_params, n_scans
    ):
        def f(mk, ri, b, s, co, ro, es, rp):
            return run_round(mk, ri, b, s, co, ro, es, rp, n_scans)

        if mesh is None:
            return f(
                master_key, round_idx, ladder, states, chain_of, replica_of, exp_state, ref_params
            )
        from jax.sharding import PartitionSpec as P

        S = P(mesh.axis)
        if shard_replicates:
            # independent ladders block-partitioned over devices: every input
            # with a leading replicate axis is sharded, everything else
            # replicated; no collective appears anywhere in the round
            wrapped = jax.shard_map(
                f,
                mesh=mesh.mesh,
                in_specs=(S, P(), P(), S, S, S, P(), P()),
                out_specs=(S, S, S, S, P(None, mesh.axis)),
                check_vma=False,
            )
        else:
            wrapped = jax.shard_map(
                f,
                mesh=mesh.mesh,
                in_specs=(P(), P(), P(), S, P(), P(), P(), P()),
                out_specs=(S, P(), P(), P(), P()),
                check_vma=False,
            )
        return wrapped(
            master_key, round_idx, ladder, states, chain_of, replica_of, exp_state, ref_params
        )

    return round_kernel


def _device_peak_memory() -> int:
    """Max peak device memory across local devices — the analogue of the
    reference's per-round allocation extrema (``recorders/recorder.jl:118-142``
    wraps ``@timed`` alloc stats in NonReproducible: a diagnostic excluded
    from reproducibility comparisons; this is host-queried, never in-graph)."""
    peak = 0
    try:
        for d in jax.local_devices():
            stats = d.memory_stats() or {}
            peak = max(peak, int(stats.get("peak_bytes_in_use", 0)))
    except Exception:
        pass
    return peak


@dataclass
class RoundReport:
    round_idx: int
    n_scans: int
    n_tempered_restarts: int
    n_round_trips: int
    global_barrier: float
    log_z_estimate: float
    min_swap_accept: float
    mean_swap_accept: float
    wall_time_s: float
    global_barrier_variational: float = float("nan")
    peak_memory_bytes: int = 0
    # reference report.jl:22-25 columns: max|ρ| (lag-1 energy autocorrelation
    # across chains) and mean(αₑ) (explorer MH/considered acceptance)
    max_energy_ac1: float = float("nan")
    mean_explorer_accept: float = float("nan")


class PT:
    """Run state + driver (reference ``src/pt/PT.jl``, ``src/pt/pigeons.jl``).

    Chain layout (0-indexed): with a single leg, chains 0..N-1 run beta
    increasing from the reference (0) to the target (N-1). With two legs
    (stabilized variational PT, reference ``src/tempering/StabilizedPT.jl``),
    chains 0..n_var-1 form the variational leg (variational reference at 0,
    target at n_var-1) and chains n_var..N-1 the fixed leg REVERSED (target at
    n_var, fixed reference at N-1); both references regenerate iid and the two
    middle chains are both targets (``create_replica_indexer`` diagram).
    """

    def __init__(self, inputs: Inputs):
        self.inputs = inputs
        target = inputs.target
        if target is None:
            raise ValueError(
                "Inputs.target is required, e.g. pigeons(target=toy_mvn_target(10))"
            )
        self.dtype = (
            jnp.dtype(inputs.dtype).type if inputs.dtype is not None else jnp.float32
        )
        if self.dtype == jnp.float64 and not jax.config.read("jax_enable_x64"):
            raise ValueError(
                "Inputs.dtype=float64 requires JAX x64 mode: set "
                "JAX_ENABLE_X64=1 or jax.config.update('jax_enable_x64', True) "
                "before creating arrays"
            )
        self.n_chains_fixed = inputs.n_chains
        self.n_chains_var = inputs.n_chains_variational
        self.variational = inputs.variational
        if self.n_chains_var > 0 and self.variational is None:
            from .variational import GaussianReference

            self.variational = GaussianReference()
        self.two_leg = self.n_chains_fixed > 0 and self.n_chains_var > 0
        if self.n_chains_var > 0 and self.n_chains_fixed == 0:
            # single variational leg (reference tempering.jl:65-70 picks
            # NonReversiblePT whose reference is updated between rounds)
            self.n_chains_fixed, self.n_chains_var = self.n_chains_var, 0
            self.single_leg_variational = True
        else:
            self.single_leg_variational = self.variational is not None and not self.two_leg
        n = self.n_chains_fixed + self.n_chains_var
        self.n_chains = n

        # assemble the annealing path
        reference = inputs.reference or target.default_reference()
        self.reference = reference
        path = target.create_path(reference)
        self.path = path

        variational = self.variational
        if variational is not None:
            self._ref_params = variational.init_params(target.dim)

            def path_log_density(x, beta, isvar, ref_params):
                # the variational leg's reference is the fitted Gaussian once
                # active; the fixed leg (and pre-activation) uses `path`
                l_fixed = path.log_density(x, beta)
                l_var_ref = variational.log_density(x, ref_params)
                l_target = path.log_density(x, jnp.ones_like(beta))
                from .paths import _guarded_mul

                l_var = _guarded_mul(1.0 - beta, l_var_ref) + _guarded_mul(
                    beta, l_target
                )
                use_var = (isvar > 0) & (ref_params["active"] > 0)
                return jnp.where(use_var, l_var, l_fixed)

        else:
            self._ref_params = ()

            def path_log_density(x, beta, isvar, ref_params):
                del isvar, ref_params
                return path.log_density(x, beta)

        sample_ref = None
        if getattr(path, "has_iid_reference", False):
            if variational is not None:

                def sample_ref(key, isvar, ref_params):
                    fixed = path.sample_reference(key)
                    var = variational.sample(key, ref_params)
                    use_var = (isvar > 0) & (ref_params["active"] > 0)
                    return jnp.where(use_var, var, fixed)

            else:
                sample_ref = lambda key, isvar, ref_params: path.sample_reference(key)
        self._path_log_density = path_log_density
        self._sample_reference = sample_ref

        # coordinate-wise density decomposition: lets the Pallas slice
        # sampler evaluate single-coordinate proposals as O(1) deltas (and
        # run the banded kernel's independent 1-D machines). coord_arrays_fn
        # maps ref_params -> per-coordinate [dim] parameter vectors, which
        # reach the kernel as banded blocks (never gathered by traced index)
        # and are handed to ld_coord as already-gathered scalars.
        ld_coord = None
        coord_arrays_fn = None
        if getattr(path, "has_coordwise", False):
            if variational is None:

                def ld_coord(v, c, beta, isvar, ref_params):
                    del isvar, ref_params
                    lp = path.coord_log_density(v, c, beta)
                    return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

            elif hasattr(variational, "coord_log_density"):
                # mean-field references are additively separable, so the
                # variational leg's path decomposes coordinate-wise too
                from .paths import _guarded_mul

                def ld_coord(v, c, beta, isvar, ref_params, mean_c, std_c):
                    l_fixed = path.coord_log_density(v, c, beta)
                    l_ref = variational.coord_log_density(v, mean_c, std_c)
                    l_tgt = path.coord_log_density(v, c, jnp.ones_like(beta))
                    l_var = _guarded_mul(1.0 - beta, l_ref) + _guarded_mul(
                        beta, l_tgt
                    )
                    use_var = (isvar > 0) & (ref_params["active"] > 0)
                    lp = jnp.where(use_var, l_var, l_fixed)
                    return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

                coord_arrays_fn = variational.coord_param_arrays
        self._ld_coord = ld_coord
        self._coord_arrays_fn = coord_arrays_fn

        self.explorer = inputs.explorer or target.default_explorer()
        self.exp_state = self.explorer.init_state(n, target.dim)

        accept_fn = metropolis_accept_pr
        record_swap_stats = True
        if hasattr(target, "swap_accept_fn"):
            accept_fn = target.swap_accept_fn()
            record_swap_stats = False  # reference pair_swapper.jl:133-135
        self.accept_fn = accept_fn

        if self.two_leg:
            self.schedule = equally_spaced_schedule(self.n_chains_fixed)
            self.schedule_var = equally_spaced_schedule(self.n_chains_var)
        else:
            self.schedule = equally_spaced_schedule(n)
            self.schedule_var = None
        self.barriers: Optional[CommunicationBarriers] = None
        self.barriers_var: Optional[CommunicationBarriers] = None

        # replica state
        key = rng.master_key(inputs.seed)
        R = inputs.n_replicates
        self.n_replicates = R
        if R > 1:
            # R independent ladders: replicate r's streams derive from
            # fold_in(master, r), so each ladder is a fresh deterministic run
            self._key = jax.vmap(lambda r: jax.random.fold_in(key, r))(jnp.arange(R))
            init_keys = jax.vmap(
                lambda k: rng.replica_keys(jax.random.fold_in(k, rng.INIT), n)
            )(self._key)
            self.states = jax.vmap(jax.vmap(target.initialization))(init_keys).astype(
                self.dtype
            )
            self.chain_of = jnp.tile(jnp.arange(n, dtype=jnp.int32), (R, 1))
            self.replica_of = jnp.tile(jnp.arange(n, dtype=jnp.int32), (R, 1))
        else:
            self._key = key
            init_keys = rng.replica_keys(jax.random.fold_in(key, rng.INIT), n)
            self.states = jax.vmap(target.initialization)(init_keys).astype(self.dtype)
            self.chain_of = jnp.arange(n, dtype=jnp.int32)
            self.replica_of = jnp.arange(n, dtype=jnp.int32)

        self.mesh = inputs.mesh
        if self.mesh is not None:
            if R > 1:
                # replicate-axis sharding: R independent ladders partitioned
                # over the mesh (each device runs R/n_dev full ladders)
                if R % self.mesh.n_devices != 0:
                    raise ValueError(
                        f"n_replicates ({R}) must be divisible by the mesh "
                        f"size ({self.mesh.n_devices})"
                    )
                from .parallel.sharding import put_global

                sh = self.mesh.sharding()
                self.states = put_global(self.states, sh)
                # PRNG key arrays round-trip through key_data for the
                # multi-process path (raw keys have an opaque dtype)
                self._key = jax.random.wrap_key_data(
                    put_global(jax.random.key_data(self._key), sh)
                )
                self.chain_of = put_global(self.chain_of, sh)
                self.replica_of = put_global(self.replica_of, sh)
            else:
                self.mesh.validate(n)
                self.states = self.mesh.shard_states(self.states)

        self.round_idx = 0
        self.reduced: Optional[ReducedRecorders] = None
        self.reports: list[RoundReport] = []
        self.traces = None  # last round's target-chain samples [n_scans, d+1]
        self.extended_traces = None  # [(R,)? n_scans, N, d+1] when requested
        self.index_process = None
        self.exec_folder: Optional[str] = None
        if inputs.checkpoint:
            from .checkpoint import next_exec_folder

            self.exec_folder = inputs.checkpoint_folder or next_exec_folder()

        if self.two_leg:
            # targets sit at the junction of the legs (StabilizedPT.jl diagram)
            self.target_positions = (self.n_chains_var - 1, self.n_chains_var)
        else:
            self.target_positions = (n - 1,)

        # trace extractor (reference Inputs.extractor): default appends the
        # interpolated log density to the state (pt/state.jl:90-99)
        extract_fn = inputs.extractor or (
            lambda x, lp: jnp.concatenate([x, lp[None]])
        )
        self._extract_dim = int(
            jax.eval_shape(
                extract_fn,
                jax.ShapeDtypeStruct((target.dim,), self.dtype),
                jax.ShapeDtypeStruct((), self.dtype),
            ).shape[0]
        )

        # batched explorers (pallas kernels) take the whole replica batch in
        # one call — including under a sharded mesh, where each device runs
        # the kernel on its own lane block (distribution never changes the
        # algorithm, the analogue of reference Entangler.jl:63-89); fall back
        # to the vmapped per-replica path only when the explorer cannot
        # consume this run's reference params or the target is host-evaluated
        use_batched = (
            self.dtype == jnp.float32
            and getattr(self.explorer, "batched", False)
            and not getattr(target, "host_evaluated", False)
            and getattr(self.explorer, "supports_ref_params", lambda rp: False)(
                self._ref_params
            )
        )

        # Inputs.record gating (reference @record_if_requested!): recorders the
        # user disabled are never traced into the kernel. Exceptions that stay
        # on regardless: swap acceptance (drives schedule adaptation), explorer
        # acceptance/steps/extras (drive explorer adaptation; [N] scalars), and
        # online moments whenever adaptation needs them (adapting
        # preconditioners, variational fits) — the analogue of the reference's
        # union of user + explorer + tempering + variational recorder builders
        # (recorders/recorders.jl:63-70).
        rec_set = set(inputs.record)
        from .inputs import KNOWN_RECORDERS

        unknown = rec_set - KNOWN_RECORDERS
        if unknown:
            # fail at construction (run_round() users never reach
            # preflight_checks): a typo would silently disable a recorder
            raise ValueError(
                f"unknown recorder name(s) {sorted(unknown)}; known "
                f"recorders: {sorted(KNOWN_RECORDERS)}"
            )
        needs_online = self.variational is not None or (
            self.explorer.needs_online_moments()
            if hasattr(self.explorer, "needs_online_moments")
            else False
        )
        self._record_online = "online" in rec_set or needs_online
        self._record_traces = "traces" in rec_set or "disk" in rec_set

        self._kernel = _make_round_kernel(
            path_log_density,
            sample_ref,
            self.explorer,
            accept_fn,
            n,
            target_positions=self.target_positions,
            extract_fn=extract_fn,
            extract_dim=self._extract_dim,
            record_extended_traces=inputs.extended_traces,
            record_index_process="index_process" in inputs.record,
            record_swap_stats=record_swap_stats and "log_sum_ratio" in rec_set,
            record_energy="energy_ac1" in rec_set,
            record_online=self._record_online,
            record_round_trip="round_trip" in rec_set,
            record_traces=self._record_traces,
            use_iid_reference=sample_ref is not None,
            mesh=self.mesh,
            n_replicates=R,
            use_batched_explorer=use_batched,
            ld_coord=self._ld_coord,
            coord_arrays_fn=self._coord_arrays_fn,
            host_sequential=getattr(target, "host_evaluated", False),
            swap_graph=inputs.swap_graph,
        )

    # ------------------------------------------------------------------

    @property
    def betas(self) -> jax.Array:
        """Per-chain annealing parameters for the combined ladder."""
        if self.two_leg:
            return jnp.asarray(
                np.concatenate([self.schedule_var.grids, self.schedule.grids[::-1]]),
                dtype=self.dtype,
            )
        return jnp.asarray(self.schedule.grids, dtype=self.dtype)

    def _ladder(self) -> dict:
        n = self.n_chains
        is_var = np.zeros(n, np.float32)
        ref_mask = np.zeros(n, bool)
        target_mask = np.zeros(n, bool)
        if self.two_leg:
            is_var[: self.n_chains_var] = 1.0
            ref_mask[0] = ref_mask[n - 1] = True
            target_mask[self.n_chains_var - 1] = target_mask[self.n_chains_var] = True
        else:
            if self.single_leg_variational:
                is_var[:] = 1.0
            ref_mask[0] = True
            target_mask[n - 1] = True
        return {
            "betas": self.betas,
            "is_var": jnp.asarray(is_var),
            "ref_mask": jnp.asarray(ref_mask),
            "target_mask": jnp.asarray(target_mask),
        }

    def run_round(self, n_scans: Optional[int] = None) -> ReducedRecorders:
        import contextlib

        self.round_idx += 1
        if n_scans is None:
            n_scans = 2**self.round_idx
        profile_ctx = contextlib.nullcontext()
        if (
            self.inputs.profile_round
            and self.round_idx >= self.inputs.profile_round
            and self.exec_folder is not None
        ):
            # per-round device profile (XLA op timeline, memory) — the
            # tracing/observability hook SURVEY §5 calls for; inspect with
            # TensorBoard's profile plugin or Perfetto
            import os as _os

            profile_ctx = jax.profiler.trace(
                _os.path.join(self.exec_folder, "profile", f"round={self.round_idx}")
            )
        t0 = time.perf_counter()
        with profile_ctx:
            states, chain_of, replica_of, rec, outputs = self._kernel(
                self._key,
                jnp.asarray(self.round_idx),
                self._ladder(),
                self.states,
                self.chain_of,
                self.replica_of,
                self.exp_state,
                self._ref_params,
                n_scans=n_scans,
            )
            states.block_until_ready()
        wall = time.perf_counter() - t0
        self.states, self.chain_of, self.replica_of = states, chain_of, replica_of
        from .parallel.sharding import to_host

        # trace shape: [(R,)? n_scans, T, d+1] -> pooled [iterations, d+1]
        if "trace" in outputs:
            trace = to_host(outputs["trace"])
            self.traces = trace.reshape(-1, trace.shape[-1])
        else:
            self.traces = None  # traces recorder disabled via Inputs.record
        if "extended_trace" in outputs:
            self.extended_traces = to_host(outputs["extended_trace"])
        if "index_process" in outputs:
            self.index_process = to_host(outputs["index_process"])
        if "disk" in self.inputs.record and self.exec_folder is not None:
            from .checkpoint import write_samples

            write_samples(self, outputs)
        reduced = reduce_recorders(rec, self.n_replicates)
        self.reduced = reduced
        self._adapt(reduced)
        self._report(reduced, n_scans, wall)
        if self.inputs.checkpoint:
            from .checkpoint import write_checkpoint

            write_checkpoint(self)
        return reduced

    def _adapt(self, reduced: ReducedRecorders) -> None:
        rej_all = rejections_from_acceptance(
            np.nan_to_num(reduced.accept_mean, nan=0.5), reduced.accept_n
        )
        if self.two_leg:
            # per-leg schedule adaptation over each leg's own pairs; the
            # target-target junction pair is excluded from both (reference
            # StabilizedPT.jl:52-62 via leg index slices)
            n_var, n = self.n_chains_var, self.n_chains
            rej_var = rej_all[: n_var - 1]
            # fixed-leg pairs in increasing-beta order = reversed global slice
            rej_fixed = rej_all[n_var : n - 1][::-1]
            trivial = communication_barriers([0.0], [0.0, 1.0])
            if n_var > 1:
                self.barriers_var = communication_barriers(rej_var, self.schedule_var.grids)
                self.schedule_var = optimal_schedule(rej_var, self.schedule_var.grids)
            else:  # a 1-chain leg has no pairs to adapt
                self.barriers_var = trivial
            if self.n_chains_fixed > 1:
                self.barriers = communication_barriers(rej_fixed, self.schedule.grids)
                self.schedule = optimal_schedule(rej_fixed, self.schedule.grids)
            else:
                self.barriers = trivial
        elif self.n_chains > 1:
            self.barriers = communication_barriers(rej_all, self.schedule.grids)
            self.schedule = optimal_schedule(rej_all, self.schedule.grids)
        else:
            # single chain: no pairs, no barrier, schedule stays [1.0]
            self.barriers = communication_barriers([0.0], [0.0, 1.0])
        if self.variational is not None:
            self._ref_params = self.variational.fit(
                self._ref_params, reduced, self.round_idx
            )
        self.exp_state = self.explorer.adapt(self.exp_state, reduced, self.round_idx)

    def _stepping_stone_pair_mask(self) -> Optional[np.ndarray]:
        """2-leg runs estimate log Z on the variational leg only (reference
        ``evidence/stepping_stone.jl:53-67``: lower KL => lower error)."""
        if not self.two_leg:
            return None
        mask = np.zeros(self.n_chains - 1, bool)
        mask[: self.n_chains_var - 1] = True
        return mask

    def _report(self, reduced: ReducedRecorders, n_scans: int, wall: float) -> None:
        from .evidence import stepping_stone_from_reduced

        with np.errstate(invalid="ignore"):
            obs = reduced.accept_n > 0
            min_acc = float(np.min(reduced.accept_mean[obs])) if obs.any() else np.nan
            mean_acc = float(np.mean(reduced.accept_mean[obs])) if obs.any() else np.nan
            ac1 = reduced.energy_ac1[np.isfinite(reduced.energy_ac1)]
            max_ac1 = float(np.max(np.abs(ac1))) if ac1.size else np.nan
            eacc = reduced.exp_accept[np.isfinite(reduced.exp_accept)]
            mean_eacc = float(np.mean(eacc)) if eacc.size else np.nan
        report = RoundReport(
            round_idx=self.round_idx,
            n_scans=n_scans,
            n_tempered_restarts=reduced.n_tempered_restarts,
            n_round_trips=reduced.n_round_trips,
            global_barrier=self.barriers.global_barrier,
            log_z_estimate=stepping_stone_from_reduced(
                reduced, self._stepping_stone_pair_mask()
            ),
            min_swap_accept=min_acc,
            mean_swap_accept=mean_acc,
            wall_time_s=wall,
            global_barrier_variational=(
                self.barriers_var.global_barrier if self.barriers_var else float("nan")
            ),
            peak_memory_bytes=_device_peak_memory(),
            max_energy_ac1=max_ac1,
            mean_explorer_accept=mean_eacc,
        )
        self.reports.append(report)
        if self.inputs.show_report:
            var_col = f" {'Λ_var':>7}" if self.two_leg else ""
            if self.round_idx == 1:
                print(
                    f"{'round':>5} {'scans':>6} {'restarts':>8} {'trips':>6} "
                    f"{'Λ':>7}{var_col} {'logZ':>9} {'min(α)':>7} {'mean(α)':>7} "
                    f"{'max|ρ|':>7} {'mean(αe)':>8} {'time(s)':>8}"
                )
            var_val = (
                f" {report.global_barrier_variational:>7.3f}" if self.two_leg else ""
            )
            print(
                f"{report.round_idx:>5} {report.n_scans:>6} {report.n_tempered_restarts:>8} "
                f"{report.n_round_trips:>6} {report.global_barrier:>7.3f}{var_val} "
                f"{report.log_z_estimate:>9.3f} {report.min_swap_accept:>7.3f} "
                f"{report.mean_swap_accept:>7.3f} {report.max_energy_ac1:>7.3f} "
                f"{report.mean_explorer_accept:>8.3f} {report.wall_time_s:>8.3f}"
            )

    def run(self) -> "PT":
        from .checks import check_against_serial, preflight_checks

        preflight_checks(self.inputs)
        while self.round_idx < self.inputs.n_rounds:
            self.run_round()
            if self.round_idx == self.inputs.checked_round:
                check_against_serial(self)
        return self

    # ------------------------------------------------------------------
    # results API (reference src/pt/process_sample.jl, OnlineStateRecorder.jl)

    def sample_array(self) -> np.ndarray:
        """Last-round target-chain samples, [iterations, dim + 1]; the final
        column is the interpolated log density (reference ``extract_sample``
        appends it, ``src/pt/state.jl:90-99``)."""
        if self.traces is None:
            if self.round_idx > 0 and not self._record_traces:
                raise RuntimeError(
                    "the traces recorder is disabled by Inputs.record; add "
                    "'traces' (or 'disk') to record samples"
                )
            raise RuntimeError("run() first")
        return self.traces

    def extended_sample_array(self) -> np.ndarray:
        """All-chain extracts [iterations, n_chains, dim + 1] from the last
        round (requires ``extended_traces=True``; reference ``Inputs.jl:95``)."""
        if self.extended_traces is None:
            raise RuntimeError("run with extended_traces=True first")
        arr = self.extended_traces
        return arr.reshape(-1, arr.shape[-2], arr.shape[-1])

    def _require_online(self):
        if not self._record_online:
            # otherwise the gated-off accumulators would read as exact zeros
            raise RuntimeError(
                "the online-moments recorder is disabled by Inputs.record; "
                "add 'online' to compute mean()/var()"
            )

    def sample_names(self) -> list:
        """Column names of :meth:`sample_array` (reference
        ``sample_names(pt)``, ``src/pt/state.jl:60``): the target's names
        when it declares them AND they match the array's width, else
        ``x[i]``; the last column is always the interpolated log density.

        Targets whose ``sample_names`` covers transformed parameters or
        generated quantities (the Stan frontend) are asked for the bare
        parameter names (``include_tp=False, include_gq=False``), since
        ``sample_array`` holds the unconstrained parameter vector only; a
        name list that still disagrees with the column count falls back to
        positional labels rather than mislabeling columns."""
        target = self.inputs.target
        if self.inputs.extractor is None:
            # targets distinguishing unconstrained-coordinate labels (the
            # Stan frontend's `theta_unc[i]`) report those — sample_array is
            # in unconstrained space
            if hasattr(target, "unconstrained_sample_names"):
                names = list(target.unconstrained_sample_names())
                if len(names) == self._extract_dim:
                    return names
            elif hasattr(target, "sample_names"):
                try:
                    names = list(
                        target.sample_names(include_tp=False, include_gq=False)
                    )
                except TypeError:
                    names = list(target.sample_names())
                if len(names) == self._extract_dim:
                    return names
        d = self._extract_dim - 1
        return [f"x[{i}]" for i in range(d)] + ["log_density"]

    def mean(self) -> np.ndarray:
        self._require_online()
        return self.reduced.online_mean[:-1]

    def var(self) -> np.ndarray:
        self._require_online()
        return self.reduced.online_var[:-1]

    @property
    def n_round_trips(self) -> int:
        return self.reduced.n_round_trips

    @property
    def n_tempered_restarts(self) -> int:
        return self.reduced.n_tempered_restarts

    @property
    def global_barrier(self) -> float:
        """Barrier to the fixed reference (reference ``tempering.jl:50-57``)."""
        return self.barriers.global_barrier

    @property
    def global_barrier_variational(self) -> float:
        if self.barriers_var is None:
            raise ValueError("no variational leg in this run")
        return self.barriers_var.global_barrier


def pigeons(target=None, on=None, **kwargs):
    """Main entry point (reference ``src/submission/api.jl``). Accepts a
    target, an ``Inputs``, or a checkpoint folder path to resume
    (reference ``api.jl:8``: ``pigeons("results/latest")``); ``on`` selects
    the submission backend (ThisProcess/ChildProcess/ClusterSubmission/
    MultiHostLauncher) and may return a :class:`submission.Result` handle."""
    if isinstance(target, Inputs):
        inputs = target
    elif isinstance(target, str):
        from .checkpoint import load_pt

        return load_pt(target, mesh=kwargs.pop("mesh", None)).run()
    else:
        inputs = Inputs(target=target, **kwargs)
    if on is None:
        return PT(inputs).run()
    return on.submit(inputs)
