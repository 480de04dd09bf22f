"""Non-reversible DEO swaps as permutation updates.

Batched design: the reference exchanges 2 floats per pair over MPI
point-to-point and keeps a distributed chain->replica map
(``src/swap/swap.jl:53-102``, ``src/mpi_utils/PermutedDistributedArray.jl``).
Here states are a ``[N, ...]`` batch indexed by *replica* (they never move);
the index process is a replicated ``chain_of: int32[N]`` permutation. One swap
scan is a handful of gathers/scatters over length-N vectors — O(N) scalar work
independent of the state dimension, exactly the reference's design invariant
(``docs/src/pt.md:76-84``). Under a sharded mesh only the per-replica scalar
log-ratios cross devices (an all-gather of [N] floats).

DEO semantics (0-indexed chains; reference is 1-indexed):
  * reference ``src/swap/DEO.jl:10-15``: even scans use the "even" graph,
    odd scans the "odd" graph (scan counter starts at 1);
  * reference ``src/swap/OddEven.jl:23-31``: Julia chain c partners with
    c + 1 if iseven(c) == even else c - 1, clamped to self at the boundary.
    In 0-indexed terms: odd graph pairs (0,1),(2,3),...; even graph pairs
    (1,2),(3,4),...
  * swap decision (``src/swap/pair_swapper.jl:81-85``): shared uniform taken
    from the lower-indexed chain; accept iff u < min(1, exp(r1 + r2)).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from . import rng


def deo_partner_map(n_chains: int, scan_idx) -> jax.Array:
    """partner[c] for each chain c under the DEO graph of scan ``scan_idx``
    (1-indexed scan counter, as in the reference's Iterators)."""
    offset = jnp.where(scan_idx % 2 == 0, 1, 0)  # even scan -> pairs start at chain 1
    c = jnp.arange(n_chains)
    direction = jnp.where((c - offset) % 2 == 0, 1, -1)
    partner = c + direction
    return jnp.where((partner < 0) | (partner >= n_chains), c, partner)


def metropolis_accept_pr(stat_sum):
    return jnp.minimum(1.0, jnp.exp(stat_sum))


class SwapResult(NamedTuple):
    chain_of: jax.Array  # [N] updated replica -> chain permutation
    replica_of: jax.Array  # [N] updated chain -> replica permutation
    pair_active: jax.Array  # [N-1] bool: pair (c, c+1) interacted this scan
    accept_pr: jax.Array  # [N-1] acceptance probability per pair (0 where inactive)
    ratio_fwd: jax.Array  # [N-1] log-ratio recorded for key (c, c+1)
    ratio_bwd: jax.Array  # [N-1] log-ratio recorded for key (c+1, c)
    do_swap: jax.Array  # [N-1] bool swap decisions


def swap_scan(
    swap_key: jax.Array,
    scan_idx,
    chain_of: jax.Array,
    replica_of: jax.Array,
    log_ratio: jax.Array,
    accept_fn: Callable = metropolis_accept_pr,
    partner_map: jax.Array = None,
) -> SwapResult:
    """One communication step over an arbitrary swap graph.

    ``partner_map[c]`` is the chain that chain ``c`` interacts with this scan
    (an involution; ``partner_map[c] == c`` means idle) — the batched form of the
    reference's ``swap_graph`` extension point (``src/swap/swap_graph.jl``:
    ``partner_chain(graph, chain)``; canonical instance Odd/Even, extension
    examples "parallel parallel tempering", multi-leg variational). Defaults
    to the DEO graph of ``scan_idx``.

    ``log_ratio[r]`` is the replica-r swap statistic
    ``log pi_{partner}(x_r) - log pi_{own}(x_r)`` (the reference's
    ``swap_stat``, ``pair_swapper.jl:42-47``). The pair statistic is the sum of
    the two halves; the decision is symmetric by construction since both halves
    are computed from replicated data.
    """
    n = chain_of.shape[0]
    if partner_map is None:
        partner_map = deo_partner_map(n, scan_idx)

    # per-chain views (gather by the chain -> replica permutation)
    ratio_by_chain = log_ratio[replica_of]

    # per-replica uniforms, mirroring one RNG stream per replica; the pair
    # consumes the uniform of the replica sitting at the lower chain.
    u = jax.vmap(
        lambda r: jax.random.uniform(jax.random.fold_in(swap_key, r), ())
    )(jnp.arange(n))
    u_by_chain = u[replica_of]

    # interacting pairs indexed by their LOWER chain c (every pair has a
    # unique low end <= N-2), padded to length max(N-1, 1) so recorder
    # shapes stay valid for the N=1 edge case
    c = jnp.arange(max(n - 1, 1))
    partner_c = partner_map[jnp.minimum(c, n - 1)]
    pair_active = partner_c > c
    ratio_fwd = ratio_by_chain[c]  # stat of the replica at chain c
    ratio_bwd = ratio_by_chain[partner_c]
    stat_sum = ratio_fwd + ratio_bwd
    accept_pr = jnp.where(pair_active, accept_fn(stat_sum), 0.0)
    do_swap = pair_active & (u_by_chain[c] < accept_pr)

    # chain-level destination permutation: a chain in a swapped pair moves to
    # its partner's slot; the involution is its own inverse, so one gather
    # maintains chain_of and one maintains replica_of (a scatter may serialize)
    cidx = jnp.arange(n, dtype=chain_of.dtype)
    low = jnp.minimum(cidx, partner_map.astype(chain_of.dtype))
    swapped_chain = do_swap[jnp.minimum(low, max(n - 2, 0))] & (
        partner_map != cidx
    )
    dest = jnp.where(swapped_chain, partner_map.astype(chain_of.dtype), cidx)

    new_chain_of = dest[chain_of]
    new_replica_of = replica_of[dest]
    return SwapResult(
        chain_of=new_chain_of,
        replica_of=new_replica_of,
        pair_active=pair_active,
        accept_pr=accept_pr,
        ratio_fwd=ratio_fwd,
        ratio_bwd=ratio_bwd,
        do_swap=do_swap,
    )
