"""Explorer interface: within-chain MCMC kernels as vmappable JAX functions.

Reference interface (``src/explorers/explorer.jl:7-55``): ``step!`` must leave
the replica's current tempered distribution invariant; ``adapt_explorer`` runs
between rounds. The batched contract:

  * ``step(key, x, lp0, lp_fn, beta, chain_params, scan_idx) -> StepOut``
    operates on a SINGLE replica with static shapes and bounded control flow;
    the runtime vmaps it over the whole replica batch so all chains' density
    evaluations fuse into one XLA computation.
  * ``init_state(n_chains, dim)`` returns the per-chain adaptation pytree
    (every leaf shaped ``[n_chains, ...]``); ``chain_params`` passed to
    ``step`` is that pytree gathered at the replica's current chain.
  * ``adapt(state, reduced, round_idx)`` runs host-side between rounds.
  * ``extra_names`` declares explorer-specific per-chain statistics (the
    analogue of the reference's opt-in recorder builders, e.g. AutoMALA's
    ``am_factors``/``reversibility_rate``); ``StepOut.extras_sum``/``extras_n``
    carry one (sum, count) pair per name, accumulated per chain by the runtime
    and surfaced as ``reduced.extra_mean``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp


class StepOut(NamedTuple):
    x: jax.Array
    lp: jax.Array  # log density of x at the replica's current beta
    accept_sum: jax.Array  # contribution to explorer_acceptance_pr
    accept_n: jax.Array
    n_steps: jax.Array  # contribution to explorer_n_steps (log-density evals)
    extras_sum: Any = ()  # [K] explorer-specific stat sums (K = len(extra_names))
    extras_n: Any = ()


def _zero_stats():
    z = jnp.zeros((), jnp.float32)
    return z, z, z


def no_extras(n: int):
    return jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.float32)


class Explorer:
    extra_names: tuple = ()

    def init_state(self, n_chains: int, dim: int) -> Any:
        return ()

    def step(self, key, x, lp0, lp_fn, beta, chain_params, scan_idx) -> StepOut:
        raise NotImplementedError

    def adapt(self, state, reduced, round_idx: int):
        return state

    def needs_online_moments(self) -> bool:
        """True when between-round adaptation reads ``reduced.online_var``
        (preconditioner re-estimation). The runtime keeps the online-moment
        recorder active for such explorers even when the user's
        ``Inputs.record`` omits it — the analogue of the reference
        auto-registering ``_transformed_online`` via
        ``explorer_recorder_builders`` (``recorders/recorders.jl:63-70``)."""
        return False


class ToyExplorer(Explorer):
    """iid regeneration at every chain, for paths that are iid-sampleable at
    every beta (reference ``src/explorers/ToyExplorer.jl``)."""

    def __init__(self, path):
        self.path = path  # must provide sample_at(key, beta)

    def step(self, key, x, lp0, lp_fn, beta, chain_params, scan_idx) -> StepOut:
        x_new = self.path.sample_at(key, beta)
        a, n, s = _zero_stats()
        return StepOut(x_new, lp_fn(x_new), a, n, s)


class NoOpExplorer(Explorer):
    """Identity move, used with the TestSwapper communication-only toy target
    (reference ``pair_swapper.jl:139-141``: its explorer is ``nothing``)."""

    def step(self, key, x, lp0, lp_fn, beta, chain_params, scan_idx) -> StepOut:
        a, n, s = _zero_stats()
        return StepOut(x, lp0, a, n, s)
