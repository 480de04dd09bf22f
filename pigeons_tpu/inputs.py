"""Run configuration: the single ``Inputs`` struct.

Reference: ``src/pt/Inputs.jl:9-102`` — one kwdef struct is the entire run
config; defaults seed=1, n_rounds=10, n_chains=10.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

RECORD_DEFAULT = ("swap_acceptance_pr", "log_sum_ratio", "round_trip", "traces", "online")
RECORD_ALL = RECORD_DEFAULT + ("index_process", "energy_ac1")
# every gateable recorder name (preflight validates Inputs.record against
# this set so typos fail loudly instead of silently disabling a recorder)
KNOWN_RECORDERS = frozenset(RECORD_ALL) | {"disk"}


@dataclass
class Inputs:
    target: Any
    seed: int = 1
    n_rounds: int = 10
    n_chains: int = 10
    # Number of independent PT ladders batched on the device (a batched capability:
    # vmapped replicate systems share one compiled kernel; recorders pool
    # across replicates, multiplying effective samples per wall-clock second).
    n_replicates: int = 1
    n_chains_variational: int = 0
    reference: Optional[Any] = None
    variational: Optional[Any] = None
    checkpoint: bool = False
    checkpoint_folder: Optional[str] = None
    # Reference checks.jl: at this round, re-run serially from scratch and
    # require bitwise agreement (0 disables the check).
    checked_round: int = 0
    record: Sequence[str] = field(default_factory=lambda: RECORD_DEFAULT)
    explorer: Optional[Any] = None
    # Custom trace extractor (x, log_density) -> vector (reference
    # Inputs.extractor); default appends the log density to the state.
    extractor: Optional[Any] = None
    show_report: bool = True
    extended_traces: bool = False
    # Optional ReplicaMesh: shard the replica axis over a 1-D device mesh
    # (the analogue of launching the reference over MPI processes).
    mesh: Optional[Any] = None
    # Capture a JAX profiler trace (XLA op timeline, HBM usage; view with
    # TensorBoard or Perfetto) of each round >= profile_round under
    # ``<exec_folder>/profile/`` — the analogue of the reference's
    # per-round @timed instrumentation (recorders/recorder.jl:118-142).
    # 0 disables. Requires checkpoint=True or an explicit checkpoint_folder.
    profile_round: int = 0
    # State/density compute dtype. None selects float32 (the
    # default; recorders compensate accumulation back to ~f64 accuracy).
    # Pass jnp.float64 (or "float64") for ill-conditioned targets whose
    # density saturates in f32 — the reference computes in Float64 throughout
    # (src/pt/state.jl); requires JAX x64 mode (JAX_ENABLE_X64=1 or
    # jax.config.update("jax_enable_x64", True)) and runs on CPU or with
    # XLA explorers (the Pallas fast path is f32-only).
    dtype: Optional[Any] = None
    # Custom swap graph: traced ``(n_chains, scan_idx) -> int32[N]`` partner
    # map (an involution; partner[c] == c means chain c idles this scan).
    # None selects the non-reversible DEO graph. The batched form of the
    # reference's swap_graphs extension point (``src/swap/swap_graph.jl``).
    # Note: schedule adaptation interprets pair statistics as ADJACENT-pair
    # rejection rates, so non-adjacent custom graphs should run with
    # adaptation converged or disabled.
    swap_graph: Optional[Any] = None

    def __post_init__(self):
        self.record = tuple(self.record)

    @property
    def n_chains_total(self) -> int:
        return self.n_chains + self.n_chains_variational
