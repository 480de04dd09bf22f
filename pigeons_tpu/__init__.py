"""pigeons_tpu: non-reversible parallel tempering on accelerators (JAX/XLA).

A from-scratch framework with the capabilities of Pigeons.jl
(Julia-Tempering), designed for a GPU: the chain ladder is a batched SoA
pytree vmapped on the device and sharded over a device mesh; DEO swaps are
permutation updates over replicated index vectors; adaptation reduces
fixed-shape statistics. See SURVEY.md at the repo root for the reference map.
"""

import os as _os

# XLA's GPU autotuner chooses each fusion's code by timing it, so the same
# per-lane density compiled at two batch sizes, or in two processes, can
# round differently. With autotuning off, sharded runs and the serial check
# stay bitwise equal to their one-device twins. Takes effect when this
# package is imported before JAX opens a GPU; an explicit level is kept.
if "xla_gpu_autotune_level" not in _os.environ.get("XLA_FLAGS", ""):
    _os.environ["XLA_FLAGS"] = (
        _os.environ.get("XLA_FLAGS", "") + " --xla_gpu_autotune_level=0"
    ).strip()

from .adaptation import communication_barriers, optimal_schedule
from .evidence import stepping_stone, stepping_stone_pair
from .inputs import Inputs
from .diagnostics import ess, reports_dataframe, split_rhat, summary, swap_prs_dataframe
from .models import (
    BayesianModel,
    BlangTarget,
    ExternalTarget,
    LazyTarget,
    NativeTarget,
    StanTarget,
    StreamTarget,
    TreePPLTarget,
    ising_target,
    TestSwapper,
    banana,
    bernoulli_target,
    eight_schools,
    funnel,
    hierarchical_normal,
    logistic_regression,
    mrna_target,
    mvn_target,
    binary_mixture_target,
    poisson_count_target,
    stan_target,
    toy_mvn_target,
    unid_target,
)
from .ops import (
    AAPS,
    BinaryGibbs,
    AutoMALA,
    Compose,
    DiagonalPreconditioner,
    IdentityPreconditioner,
    MALA,
    Mix,
    ScanMix,
    MixDiagonalPreconditioner,
    NoOpExplorer,
    NUTS,
    SliceSampler,
    SliceSamplerPallas,
    ToyExplorer,
)
from .paths import InterpolatingPath, ScaledPrecisionNormalPath, toy_mvn_path
from .pt import PT, pigeons
from .schedule import Schedule, equally_spaced_schedule
from .variational import GaussianReference

__version__ = "0.1.0"

__all__ = [
    "PT",
    "pigeons",
    "Inputs",
    "Schedule",
    "equally_spaced_schedule",
    "communication_barriers",
    "optimal_schedule",
    "stepping_stone",
    "stepping_stone_pair",
    "toy_mvn_target",
    "TestSwapper",
    "BayesianModel",
    "ExternalTarget",
    "BlangTarget",
    "LazyTarget",
    "NativeTarget",
    "StreamTarget",
    "TreePPLTarget",
    "ising_target",
    "BinaryGibbs",
    "ess",
    "summary",
    "split_rhat",
    "reports_dataframe",
    "swap_prs_dataframe",
    "banana",
    "bernoulli_target",
    "eight_schools",
    "funnel",
    "hierarchical_normal",
    "logistic_regression",
    "mrna_target",
    "mvn_target",
    "binary_mixture_target",
    "poisson_count_target",
    "StanTarget",
    "stan_target",
    "unid_target",
    "SliceSampler",
    "SliceSamplerPallas",
    "ToyExplorer",
    "NoOpExplorer",
    "MALA",
    "AutoMALA",
    "AAPS",
    "NUTS",
    "Mix",
    "ScanMix",
    "Compose",
    "IdentityPreconditioner",
    "DiagonalPreconditioner",
    "MixDiagonalPreconditioner",
    "GaussianReference",
    "InterpolatingPath",
    "ScaledPrecisionNormalPath",
    "toy_mvn_path",
]
