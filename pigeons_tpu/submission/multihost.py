"""Multi-host execution: ``jax.distributed`` + the replica mesh over all
global devices.

The reference's distributed backend is MPI (one process per rank exchanging
point-to-point messages, ``src/mpi_utils/``). The equivalent here is
SPMD: every host runs the SAME program; ``jax.distributed.initialize`` wires
the hosts into one runtime; the replica mesh spans all global devices and XLA
collectives (all_gather/psum inside the round kernel) ride ICI/DCN. No
explicit messaging code exists at this layer at all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ThisProcess:
    """Run in the current process (reference ``ThisProcess``, api.jl)."""

    def submit(self, inputs):
        from ..pt import PT

        return PT(inputs).run()


@dataclass
class MultiHostLauncher:
    """Initialize jax.distributed and run with the replica axis sharded over
    ALL global devices. Invoke the same script on every host (e.g. via
    ``srun``), passing coordinator/process info either here
    or through the standard cluster env vars JAX auto-detects."""

    coordinator_address: Optional[str] = None  # host:port of process 0
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    def submit(self, inputs):
        import jax

        from ..parallel import replica_mesh
        from ..pt import PT

        kwargs = {}
        if self.coordinator_address is not None:
            kwargs = dict(
                coordinator_address=self.coordinator_address,
                num_processes=self.num_processes,
                process_id=self.process_id,
            )
        try:
            jax.distributed.initialize(**kwargs)
        except RuntimeError as e:  # already initialized (e.g. by the caller)
            if "already" not in str(e).lower():
                raise
        inputs.mesh = replica_mesh(jax.devices())  # all devices, all hosts
        pt = PT(inputs)
        pt.run()
        return pt
