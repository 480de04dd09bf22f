"""Checkpoint / resume: every round's full run state on disk.

Reference semantics (``src/pt/checkpoint.jl``): each round writes
``round=r/checkpoint/`` with replica states, shared state, reduced recorders
and inputs; a run can resume from a folder (``PT(folder)``), INCLUDING with a
different process count than the one that wrote it (elastic, ``:10-13``);
``increment_n_rounds!`` extends a finished run; ``results/all/<id>`` exec
folders with a ``results/latest`` symlink (``src/utils/exec_folder.jl``).

Layout: one ``checkpoint.npz`` of globally-indexed arrays plus a
pickled config per round. Because all state is indexed by global replica and
RNG streams derive from (seed, round, scan, replica), a checkpoint written
under any replica-mesh layout resumes bitwise-identically under any other —
the mesh is a load-time parameter, not part of the checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
import uuid
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


try:
    # closure-bearing targets (BayesianModel likelihoods, custom extractors)
    # serialize by value; cloudpickle output loads with plain pickle
    from cloudpickle import CloudPickler as _BasePickler
except ImportError:  # pragma: no cover - cloudpickle present in CI image
    _BasePickler = pickle.Pickler


class _ImmutablePickler(_BasePickler):
    """Hash-deduplicated serialization of large arrays (reference
    ``src/utils/Immutable.jl:39-87``): big datasets embedded in a target are
    written ONCE per run under ``<exec_folder>/immutables/<hash>.npy`` and
    checkpoints reference them by content hash, so per-round checkpoints stay
    small no matter how large the model's data is. Built on cloudpickle so
    closures serialize by value (the reference's ``Serialization`` handles
    Julia closures natively; its Stan ext needs a custom serializer only for
    the native model handle, ``ext/PigeonsBridgeStanExt/interface.jl:34-49``)."""

    THRESHOLD_BYTES = 1 << 14

    def __init__(self, file, immutables_dir: str):
        super().__init__(file, protocol=pickle.DEFAULT_PROTOCOL)
        self.immutables_dir = immutables_dir

    def persistent_id(self, obj):
        if isinstance(obj, jax.Array) and obj.nbytes > self.THRESHOLD_BYTES:
            obj = np.asarray(obj)  # device arrays dedup as host data too
        if (
            isinstance(obj, np.ndarray)
            and obj.nbytes > self.THRESHOLD_BYTES
            and obj.dtype != object
        ):
            import hashlib

            h = hashlib.sha256()
            h.update(str(obj.dtype).encode())
            h.update(str(obj.shape).encode())
            h.update(np.ascontiguousarray(obj).tobytes())
            digest = h.hexdigest()[:32]
            path = os.path.join(self.immutables_dir, digest + ".npy")
            if not os.path.exists(path):
                os.makedirs(self.immutables_dir, exist_ok=True)
                np.save(path, obj)
            return ("pigeons_immutable", digest)
        return None


class _ImmutableUnpickler(pickle.Unpickler):
    def __init__(self, file, immutables_dir: str):
        super().__init__(file)
        self.immutables_dir = immutables_dir
        self._cache: dict = {}

    def persistent_load(self, pid):
        tag, digest = pid
        if tag != "pigeons_immutable":
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        if digest not in self._cache:
            self._cache[digest] = np.load(
                os.path.join(self.immutables_dir, digest + ".npy")
            )
        return self._cache[digest]


def _immutables_dir(exec_folder: str) -> str:
    return os.path.join(exec_folder, "immutables")


def next_exec_folder(base: str = "results") -> str:
    """Timestamped run folder + ``results/latest`` symlink
    (reference ``utils/exec_folder.jl:8-23``)."""
    stamp = time.strftime("%Y-%m-%d-%H-%M-%S") + "-" + uuid.uuid4().hex[:8]
    folder = os.path.join(base, "all", stamp)
    os.makedirs(folder, exist_ok=True)
    latest = os.path.join(base, "latest")
    try:
        if os.path.islink(latest) or os.path.exists(latest):
            os.remove(latest)
        os.symlink(os.path.relpath(folder, base), latest)
    except OSError:
        pass  # symlinks best-effort (e.g. on restrictive filesystems)
    return folder


def round_folder(exec_folder: str, round_idx: int) -> str:
    return os.path.join(exec_folder, f"round={round_idx}", "checkpoint")


def latest_checkpoint_round(exec_folder: str) -> Optional[int]:
    """Largest round with a COMPLETE checkpoint (reference scans the
    ``.signal`` completion markers, ``checkpoint.jl:57-91``)."""
    best = None
    if not os.path.isdir(exec_folder):
        return None
    for name in os.listdir(exec_folder):
        if name.startswith("round="):
            r = int(name.split("=")[1])
            if os.path.exists(os.path.join(round_folder(exec_folder, r), ".finished")):
                best = r if best is None else max(best, r)
    return best


def write_checkpoint(pt) -> str:
    """Serialize the full run state for pt's current round."""
    folder = round_folder(pt.exec_folder, pt.round_idx)
    os.makedirs(folder, exist_ok=True)

    from .parallel.sharding import to_host

    arrays = {
        "states": to_host(pt.states),
        "chain_of": to_host(pt.chain_of),
        "replica_of": to_host(pt.replica_of),
        "schedule": np.asarray(pt.schedule.grids),
    }
    if pt.schedule_var is not None:
        arrays["schedule_var"] = np.asarray(pt.schedule_var.grids)
    if pt.traces is not None:
        # the traces recorder is checkpointed in the reference too (part of
        # the replicas' recorders, checkpoint.jl:110-145)
        arrays["traces"] = pt.traces
    if pt.index_process is not None:
        arrays["index_process"] = pt.index_process
    for i, leaf in enumerate(jax.tree.leaves(pt.exp_state)):
        arrays[f"exp_state_{i}"] = np.asarray(leaf)
    if pt._ref_params != ():
        for k, v in pt._ref_params.items():
            arrays[f"ref_params_{k}"] = np.asarray(v)
    if jax.process_index() != 0:
        # multi-process: every process joined the to_host collectives above;
        # only the coordinator writes files (reference only_one_process,
        # checkpoint.jl via mpi_utils/misc.jl)
        return folder
    np.savez(os.path.join(folder, "checkpoint.npz"), **arrays)

    # config + host-side state (inputs minus the non-picklable mesh)
    inputs = dataclasses.replace(pt.inputs, mesh=None)
    meta = {
        "inputs": inputs,
        "round_idx": pt.round_idx,
        "reports": pt.reports,
        "reduced": pt.reduced,
        "barriers": pt.barriers,
        "barriers_var": pt.barriers_var,
        "exp_state_treedef": jax.tree.structure(pt.exp_state),
    }
    with open(os.path.join(folder, "meta.pkl"), "wb") as f:
        _ImmutablePickler(f, _immutables_dir(pt.exec_folder)).dump(meta)
    # completion marker written last (reference .signal files)
    with open(os.path.join(folder, ".finished"), "w") as f:
        f.write("ok")
    return folder


def load_pt(exec_folder: str, mesh=None, round_idx: Optional[int] = None):
    """Rebuild a PT from a checkpoint folder; the replica mesh (if any) is
    supplied at load time — elastic across device layouts
    (reference ``checkpoint.jl:10-13``)."""
    from .pt import PT
    from .schedule import Schedule

    if round_idx is None:
        round_idx = latest_checkpoint_round(exec_folder)
    if round_idx is None:
        raise FileNotFoundError(f"no complete checkpoint under {exec_folder}")
    folder = round_folder(exec_folder, round_idx)
    with open(os.path.join(folder, "meta.pkl"), "rb") as f:
        meta = _ImmutableUnpickler(f, _immutables_dir(exec_folder)).load()
    arrays = np.load(os.path.join(folder, "checkpoint.npz"))

    inputs = meta["inputs"]
    inputs.mesh = mesh
    pt = PT(inputs)
    pt.exec_folder = exec_folder
    pt.round_idx = meta["round_idx"]
    pt.reports = meta["reports"]
    pt.reduced = meta["reduced"]
    pt.barriers = meta["barriers"]
    pt.barriers_var = meta["barriers_var"]
    # Re-apply the load-time mesh's layout to every run-state array, through
    # put_global so it works across jax.distributed process boundaries too
    # (the reference explicitly supports single-process checkpoints resumed
    # under MPI and vice versa, ``src/pt/checkpoint.jl:10-13``). PT(inputs)
    # already derived ``_key`` (and its sharding) from the seed.
    if mesh is not None:
        from .parallel.sharding import put_global

        if inputs.n_replicates > 1:
            # replicate-sharded mode: leading replicate axis partitioned
            sh = mesh.sharding()
            pt.states = put_global(arrays["states"], sh)
            pt.chain_of = put_global(arrays["chain_of"], sh)
            pt.replica_of = put_global(arrays["replica_of"], sh)
        else:
            # chain-sharded mode: states partitioned, permutations replicated
            pt.states = mesh.shard_states(jnp.asarray(arrays["states"]))
            rep = mesh.replicated()
            pt.chain_of = put_global(arrays["chain_of"], rep)
            pt.replica_of = put_global(arrays["replica_of"], rep)
    else:
        pt.states = jnp.asarray(arrays["states"])
        pt.chain_of = jnp.asarray(arrays["chain_of"])
        pt.replica_of = jnp.asarray(arrays["replica_of"])
    pt.schedule = Schedule(arrays["schedule"])
    if "schedule_var" in arrays:
        pt.schedule_var = Schedule(arrays["schedule_var"])
    if "traces" in arrays:
        pt.traces = arrays["traces"]
    if "index_process" in arrays:
        pt.index_process = arrays["index_process"]
    leaves = []
    i = 0
    while f"exp_state_{i}" in arrays:
        leaves.append(jnp.asarray(arrays[f"exp_state_{i}"]))
        i += 1
    pt.exp_state = jax.tree.unflatten(meta["exp_state_treedef"], leaves)
    if pt._ref_params != ():
        pt._ref_params = {
            k: jnp.asarray(arrays[f"ref_params_{k}"]) for k in pt._ref_params
        }
    return pt


def write_samples(pt, outputs) -> str:
    """Disk recorder: persist the round's traces under ``round=r/samples/``
    (reference ``recorders/DiskRecorder.jl`` zip archives)."""
    folder = os.path.join(pt.exec_folder, f"round={pt.round_idx}", "samples")
    os.makedirs(folder, exist_ok=True)
    arrays = {"trace": np.asarray(outputs["trace"])}
    if "extended_trace" in outputs:
        arrays["extended_trace"] = np.asarray(outputs["extended_trace"])
    if "index_process" in outputs:
        arrays["index_process"] = np.asarray(outputs["index_process"])
    np.savez_compressed(os.path.join(folder, "samples.npz"), **arrays)
    return folder


def process_sample(exec_folder: str, round_idx: Optional[int] = None):
    """Stream disk-recorded samples: yields (round_idx, scan_idx, extract)
    over the target-chain samples of the given round (default: all rounds),
    reference ``pt/process_sample.jl:131-182``."""
    rounds = []
    if round_idx is not None:
        rounds = [round_idx]
    else:
        for name in sorted(os.listdir(exec_folder)):
            if name.startswith("round="):
                rounds.append(int(name.split("=")[1]))
        rounds.sort()
    for r in rounds:
        path = os.path.join(exec_folder, f"round={r}", "samples", "samples.npz")
        if not os.path.exists(path):
            continue
        trace = np.load(path)["trace"]
        flat = trace.reshape(-1, trace.shape[-1])
        for i, row in enumerate(flat):
            yield r, i, row


def increment_n_rounds(exec_folder: str, extra_rounds: int, mesh=None):
    """Extend a finished run by ``extra_rounds`` (reference
    ``checkpoint.jl:166-189``)."""
    pt = load_pt(exec_folder, mesh=mesh)
    pt.inputs.n_rounds = pt.round_idx + extra_rounds
    return pt
