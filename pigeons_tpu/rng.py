"""Counter-based RNG stream derivation.

The reference (Pigeons.jl) anchors reproducibility by giving each replica its own
``SplittableRandom`` split from the master seed *by global replica index*
(reference: ``src/replicas/replicas.jl:87-98``, ``src/utils/misc.jl:17-27``), so the
random streams are a function of the replica index only and independent of the
process layout. The batched equivalent is counter-based key derivation: every
random draw's key is a pure function of ``(seed, round, scan, replica, purpose)``
via ``jax.random.fold_in``. This gives device-layout invariance by construction —
the analogue of Pigeons' "parallelism invariance" (``docs/src/distributed.md:39-44``).
"""

import jax
import jax.numpy as jnp

# Purpose tags: distinct domains so that the same (round, scan, replica) never
# reuses a key across different kinds of draws.
EXPLORE = 0
SWAP_UNIFORM = 1
IID = 2
INIT = 3


def master_key(seed: int) -> jax.Array:
    return jax.random.key(seed)


def scan_key(key: jax.Array, round_idx, scan_idx, purpose: int) -> jax.Array:
    """Key for a (round, scan, purpose) triple; fold in replica index downstream."""
    k = jax.random.fold_in(key, round_idx)
    k = jax.random.fold_in(k, scan_idx)
    return jax.random.fold_in(k, purpose)


def replica_keys(key: jax.Array, n_replicas: int) -> jax.Array:
    """One key per replica, derived by replica index (vectorized fold_in)."""
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n_replicas))


def keys_for(key: jax.Array, indices: jax.Array) -> jax.Array:
    """Keys for an explicit vector of global replica indices — under a sharded
    mesh each device derives the keys of its own shard, so the streams match
    the single-device run bit-for-bit (layout invariance)."""
    return jax.vmap(lambda i: jax.random.fold_in(key, i))(indices)
