"""Run correctness checks: parallelism-invariance verification in-product.

Reference semantics (``src/pt/checks.jl``): when ``checked_round`` is set, the
run re-executes itself from scratch in a serial 1-process ChildProcess at that
round and compares every checkpoint file with ``recursive_equal`` — bitwise
agreement of a distributed run with its serial counterpart is the product's
flagship correctness guarantee ("Parallelism Invariance").

The analogue here, with the same process boundary: the serial copy runs in a
fresh OS process (``ChildProcess``) with ``mesh=None``, and the comparison is
STRUCTURAL over the checkpoint artifacts themselves — every array in
``checkpoint.npz`` bitwise, every entry of the pickled meta recursively —
so new recorders/state can never silently escape the check
(reference ``checks.jl:80-105`` ``compare_checkpoints``/``recursive_equal``).
Known-nonreproducible diagnostics (wall time, peak device memory, folder
paths) are excluded, mirroring the reference's ``NonReproducible`` wrapper.
"""

from __future__ import annotations

import os

import numpy as np

# meta entries that legitimately differ between a run and its serial
# re-execution (the reference wraps these in NonReproducible /
# compares everything else, recorders/recorder.jl:118-142)
NONREPRODUCIBLE_META = {"inputs", "reports"}
NONREPRODUCIBLE_FIELDS = {
    "wall_time_s",
    "peak_memory_bytes",
    "checkpoint_folder",
    "exec_folder",
}


class ParallelismInvarianceError(AssertionError):
    pass


def preflight_checks(inputs) -> None:
    """Argument validation (reference ``checks.jl:1-30``)."""
    if inputs.n_chains < 0 or inputs.n_chains_variational < 0:
        raise ValueError("chain counts must be nonnegative")
    if inputs.n_chains + inputs.n_chains_variational < 1:
        raise ValueError("need at least one chain")
    if inputs.n_rounds < 0:
        raise ValueError("n_rounds must be nonnegative")
    if inputs.checked_round and not (0 < inputs.checked_round <= inputs.n_rounds):
        raise ValueError("checked_round must lie in [1, n_rounds]")
    if inputs.checked_round and not inputs.checkpoint:
        # reference checks.jl:14-16: "activate checkpoint when performing
        # checks" — the comparison is over checkpoint files
        raise ValueError("activate checkpoint when performing checks")
    if inputs.checked_round and inputs.n_replicates > 1:
        raise ValueError("checked_round with n_replicates > 1 is not supported")
    if "disk" in inputs.record and not inputs.checkpoint:
        raise ValueError("activate checkpoint when using the disk recorder")
    from .inputs import KNOWN_RECORDERS

    unknown = set(inputs.record) - KNOWN_RECORDERS
    if unknown:
        # a typo would otherwise silently disable a recorder (Inputs.record
        # gates kernel tracing since r4)
        raise ValueError(
            f"unknown recorder name(s) {sorted(unknown)}; known recorders: "
            f"{sorted(KNOWN_RECORDERS)}"
        )


def recursive_equal(a, b, path: str = "", failures=None) -> list:
    """Structural deep comparison; returns the list of differing paths
    (reference ``checks.jl:110-195``). NaNs compare equal; arrays compare
    bitwise; callables by qualified name (closures are code, not data)."""
    if failures is None:
        failures = []

    def fail():
        failures.append(path or "<root>")
        return failures

    if isinstance(a, (np.ndarray,)) or isinstance(b, (np.ndarray,)):
        a_arr, b_arr = np.asarray(a), np.asarray(b)
        if a_arr.shape != b_arr.shape or a_arr.dtype != b_arr.dtype:
            return fail()
        if a_arr.dtype == object:
            if a_arr.tolist() != b_arr.tolist():
                return fail()
            return failures
        if not np.array_equal(a_arr, b_arr, equal_nan=a_arr.dtype.kind == "f"):
            return fail()
        return failures
    import types

    if isinstance(a, types.FunctionType) or isinstance(b, types.FunctionType):
        na = getattr(a, "__qualname__", repr(a))
        nb = getattr(b, "__qualname__", repr(b))
        if na != nb:
            return fail()
        return failures
    if type(a) is not type(b):
        # namedtuple/dataclass types must match exactly
        return fail()
    if hasattr(a, "_fields"):  # namedtuple
        for f in a._fields:
            if f in NONREPRODUCIBLE_FIELDS:
                continue
            recursive_equal(getattr(a, f), getattr(b, f), f"{path}.{f}", failures)
        return failures
    import dataclasses

    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(a):
            if f.name in NONREPRODUCIBLE_FIELDS:
                continue
            recursive_equal(
                getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}", failures
            )
        return failures
    if isinstance(a, dict):
        if set(a) != set(b):
            return fail()
        for k in a:
            if k in NONREPRODUCIBLE_FIELDS:
                continue
            recursive_equal(a[k], b[k], f"{path}[{k!r}]", failures)
        return failures
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return fail()
        for i, (x, y) in enumerate(zip(a, b)):
            recursive_equal(x, y, f"{path}[{i}]", failures)
        return failures
    if isinstance(a, float) and isinstance(b, float):
        if not (a == b or (np.isnan(a) and np.isnan(b))):
            return fail()
        return failures
    if (
        type(a).__eq__ is object.__eq__
        and hasattr(a, "__dict__")
        and not isinstance(a, type)
    ):
        # plain object with default identity equality (e.g. an interpolator):
        # compare its attributes structurally instead
        return recursive_equal(vars(a), vars(b), path, failures)
    try:
        if a != b:
            return fail()
    except Exception:
        failures.append(f"{path} (incomparable {type(a).__name__})")
    return failures


def compare_checkpoint_folders(folder_a: str, folder_b: str,
                               immutables_a: str, immutables_b: str) -> list:
    """Compare EVERY checkpoint artifact of two round folders: each
    ``checkpoint.npz`` key bitwise and the unpickled ``meta.pkl`` entries
    structurally (reference ``compare_checkpoints``, ``checks.jl:80-86``)."""
    from .checkpoint import _ImmutableUnpickler

    failures = []
    npz_a = np.load(os.path.join(folder_a, "checkpoint.npz"))
    npz_b = np.load(os.path.join(folder_b, "checkpoint.npz"))
    if set(npz_a.files) != set(npz_b.files):
        failures.append(
            f"checkpoint.npz keys differ: {sorted(npz_a.files)} vs {sorted(npz_b.files)}"
        )
    for k in sorted(set(npz_a.files) & set(npz_b.files)):
        recursive_equal(npz_a[k], npz_b[k], f"npz:{k}", failures)

    def load_meta(folder, imm):
        with open(os.path.join(folder, "meta.pkl"), "rb") as f:
            return _ImmutableUnpickler(f, imm).load()

    meta_a = load_meta(folder_a, immutables_a)
    meta_b = load_meta(folder_b, immutables_b)
    for k in sorted(set(meta_a) | set(meta_b)):
        if k in NONREPRODUCIBLE_META:
            continue
        if k not in meta_a or k not in meta_b:
            failures.append(f"meta:{k} missing on one side")
            continue
        recursive_equal(meta_a[k], meta_b[k], f"meta:{k}", failures)
    return failures


def check_against_serial(pt) -> None:
    """Reference ``check_against_serial`` (``checks.jl:36-78``): re-run the
    same Inputs serially in a FRESH OS process (ChildProcess, mesh=None) up to
    the checked round and require every checkpoint artifact to agree. A
    cross-process divergence (environment-dependent state, import-order
    effects, JIT-cache leakage) is caught here; an in-process re-run could
    not see it."""
    import dataclasses

    from .checkpoint import _immutables_dir, round_folder
    from .submission.child_process import ChildProcess

    inputs = dataclasses.replace(
        pt.inputs,
        mesh=None,
        n_rounds=pt.round_idx,
        checkpoint=True,
        checked_round=0,  # otherwise infinite recursion (checks.jl:69)
        show_report=False,
    )
    result = ChildProcess(wait=True).submit(inputs)

    failures = compare_checkpoint_folders(
        round_folder(pt.exec_folder, pt.round_idx),
        round_folder(result.exec_folder, pt.round_idx),
        _immutables_dir(pt.exec_folder),
        _immutables_dir(result.exec_folder),
    )
    if failures:
        raise ParallelismInvarianceError(
            "distributed run differs from its serial cross-process "
            "re-execution in: " + ", ".join(failures[:20])
        )
