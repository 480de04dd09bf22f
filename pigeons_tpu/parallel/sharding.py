"""Replica-axis sharding over a 1-D device mesh.

SPMD replacement for the reference's MPI backend (``src/mpi_utils/``):

  * Pigeons block-partitions N chains over P processes with ``LoadBalance``
    and exchanges per-pair scalars by tagged MPI point-to-point
    (``Entangler.jl:133-184``). Here the replica axis of the state batch is
    sharded over a 1-D ``jax.sharding.Mesh``; the per-replica swap scalars are
    combined with one ``lax.all_gather`` of ``[N]`` floats per scan, riding
    ICI. Chain/replica permutations and swap decisions are computed replicated
    on every device — the analogue of the reference's "both sides compute the
    same decision" symmetry (``swap/pair_swapper.jl:81-85``).
  * ``reduce_deterministically`` (``Entangler.jl:214-277``) guarantees results
    independent of the process layout. Here per-chain recorder partials are
    combined with ``lax.psum``; every chain slot is written by exactly one
    device, so the sum adds exact zeros and the result is bitwise identical
    for any device count (see tests/test_sharded.py).

Replicas are block-partitioned in global index order: device k owns replicas
[k*N/P, (k+1)*N/P). RNG streams are derived from the *global* replica index, so
they are independent of the layout (reference ``replicas.jl:87-98`` semantics).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

REPLICA_AXIS = "replicas"


@dataclass(frozen=True)
class ReplicaMesh:
    """A 1-D mesh over which the replica axis of the state batch is sharded."""

    mesh: Mesh

    @property
    def n_devices(self) -> int:
        return self.mesh.devices.size

    @property
    def axis(self) -> str:
        return REPLICA_AXIS

    def sharding(self) -> NamedSharding:
        """Sharding for [N, ...] replica-major arrays."""
        return NamedSharding(self.mesh, P(REPLICA_AXIS))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    def shard_states(self, states: jax.Array) -> jax.Array:
        return put_global(states, self.sharding())

    def validate(self, n_chains: int) -> None:
        if n_chains % self.n_devices != 0:
            raise ValueError(
                f"n_chains ({n_chains}) must be divisible by the mesh size "
                f"({self.n_devices}); pad n_chains or use fewer devices"
            )


def replica_mesh(devices=None) -> ReplicaMesh:
    """Build the 1-D replica mesh (all local devices by default)."""
    if devices is None:
        devices = jax.devices()
    return ReplicaMesh(Mesh(np.asarray(devices), (REPLICA_AXIS,)))


def put_global(arr, sharding):
    """Place a host array under ``sharding``, working in BOTH single- and
    multi-process runs. Single process: plain ``device_put``. Multi-process
    (``jax.distributed``): every process holds the same host value (all run
    state is a deterministic function of the seed), so each process supplies
    its addressable shards via ``make_array_from_callback`` — the
    analogue of the reference's per-rank ``LoadBalance`` slice construction
    (``src/mpi_utils/LoadBalance.jl``)."""
    if sharding.is_fully_addressable:
        return jax.device_put(arr, sharding)
    host = np.asarray(arr)
    return jax.make_array_from_callback(host.shape, sharding, lambda idx: host[idx])


def to_host(arr) -> np.ndarray:
    """Fetch an array to host, working across process boundaries.

    Replicated cross-process arrays read the local copy (no communication);
    SHARDED cross-process arrays are re-laid-out replicated first, which is a
    COLLECTIVE — every process must call it (the usual SPMD contract, same as
    the reference's ``Allreduce`` discipline)."""
    if not isinstance(arr, jax.Array) or arr.is_fully_addressable:
        return np.asarray(arr)
    if arr.is_fully_replicated:
        return np.asarray(arr.addressable_shards[0].data)
    mesh = getattr(arr.sharding, "mesh", None)
    if mesh is not None:
        rep = jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))(arr)
        return np.asarray(rep.addressable_shards[0].data)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
