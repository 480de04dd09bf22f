"""Compilation-stability guardrails — the analogue of the reference's
allocation tests (``test/test_allocs.jl``: steady-state allocations must not
grow with round number). Under XLA the corresponding pathology is
RETRACING/RECOMPILING: the round kernel must compile once per distinct scan
count and be reused across rounds, replicate counts must share the kernel,
and no shapes may depend on the round index.
"""

import numpy as np

from pigeons_tpu import Inputs, PT, SliceSampler, toy_mvn_target
from pigeons_tpu.ops import AutoMALA


def _cache_size(pt):
    return pt._kernel._cache_size()


def test_round_kernel_compiles_once_for_fixed_scan_count():
    pt = PT(
        Inputs(
            target=toy_mvn_target(3),
            n_chains=4,
            n_rounds=10,
            seed=1,
            show_report=False,
        )
    )
    for _ in range(6):
        pt.run_round(n_scans=8)
    # one trace regardless of round number (the reference's "allocations
    # exactly equal across rounds" in the zero-recompile sense)
    assert _cache_size(pt) == 1


def test_round_doubling_compiles_once_per_length():
    pt = PT(
        Inputs(
            target=toy_mvn_target(2),
            n_chains=4,
            n_rounds=5,
            seed=1,
            show_report=False,
        )
    )
    pt.run()  # rounds of 2, 4, 8, 16, 32 scans
    assert _cache_size(pt) == 5  # one compile per distinct scan count only


def test_gradient_explorer_compile_stable_across_rounds():
    # AutoMALA adapts step size + preconditioner between rounds; adaptation
    # must flow through kernel ARGUMENTS, never through retraces
    pt = PT(
        Inputs(
            target=toy_mvn_target(3),
            n_chains=4,
            n_rounds=8,
            seed=2,
            explorer=AutoMALA(),
            show_report=False,
        )
    )
    for _ in range(8):
        pt.run_round(n_scans=4)
    assert _cache_size(pt) == 1


def test_dimension_does_not_leak_into_round_shapes():
    # d=1 vs d=64: same number of compiles (shape growth is in the batch
    # dims, not in trace structure) — the analogue of the reference's
    # "< 3x allocation growth from d=1 to d=100"
    sizes = []
    for d in (1, 64):
        pt = PT(
            Inputs(
                target=toy_mvn_target(d),
                n_chains=4,
                n_rounds=3,
                seed=1,
                explorer=SliceSampler(n_passes=1),
                show_report=False,
            )
        )
        for _ in range(3):
            pt.run_round(n_scans=4)
        sizes.append(_cache_size(pt))
    assert sizes[0] == sizes[1] == 1
