"""Public API surface regression (reference ``test/test_apis.jl``: the
`@informal` interfaces and exported names are themselves under test).

Locks the user-facing names documented in README/docs/migration.md and the
reference-parity constructor defaults, so refactors cannot silently drop
what a Pigeons.jl user reaching for the rosetta expects to find.
"""

import inspect

import pigeons_tpu as p


PUBLIC = [
    # running
    "pigeons", "PT", "Inputs",
    # explorers
    "SliceSampler", "SliceSamplerPallas", "MALA", "AutoMALA", "AAPS", "NUTS",
    "BinaryGibbs", "Mix", "ScanMix", "Compose", "ToyExplorer", "NoOpExplorer",
    "IdentityPreconditioner", "DiagonalPreconditioner",
    "MixDiagonalPreconditioner",
    # targets / frontends
    "BayesianModel", "NativeTarget", "StreamTarget", "BlangTarget",
    "TreePPLTarget", "ExternalTarget", "LazyTarget", "TestSwapper",
    "toy_mvn_target", "funnel", "banana", "eight_schools", "unid_target",
    "mrna_target", "bernoulli_target", "logistic_regression",
    "hierarchical_normal", "ising_target", "poisson_count_target",
    # variational / evidence / schedule
    "GaussianReference", "stepping_stone", "stepping_stone_pair",
    "Schedule", "equally_spaced_schedule", "optimal_schedule",
    "communication_barriers",
    # diagnostics
    "summary", "ess", "split_rhat", "reports_dataframe", "swap_prs_dataframe",
]


def test_public_names_exist():
    missing = [n for n in PUBLIC if not hasattr(p, n)]
    assert not missing, f"public API names missing: {missing}"


def test_inputs_fields_match_reference():
    # reference Inputs.jl:9-102 field set (+ batched additions)
    fields = set(p.Inputs.__dataclass_fields__)
    for name in [
        "target", "seed", "n_rounds", "n_chains", "n_chains_variational",
        "reference", "variational", "checkpoint", "checked_round", "record",
        "explorer", "extractor", "show_report", "extended_traces",
        # batched additions
        "n_replicates", "mesh", "swap_graph", "profile_round", "dtype",
    ]:
        assert name in fields, name


def test_reference_parity_defaults():
    # SliceSampler.jl: w=10.0, p=20, n_passes=3
    sig = inspect.signature(p.SliceSampler.__init__)
    assert sig.parameters["w"].default == 10.0
    assert sig.parameters["p"].default == 20
    assert sig.parameters["n_passes"].default == 3
    # AutoMALA.jl: base_n_refresh=3, exponent_n_refresh=0.35, MixDiagonal
    sig = inspect.signature(p.AutoMALA.__init__)
    assert sig.parameters["base_n_refresh"].default == 3
    assert sig.parameters["exponent_n_refresh"].default == 0.35
    # Inputs.jl defaults: seed=1, n_rounds=10, n_chains=10
    i = p.Inputs(target=None)
    assert (i.seed, i.n_rounds, i.n_chains) == (1, 10, 10)
    # submission utilities reachable (api.jl / presets.jl surface)
    from pigeons_tpu import submission as sub

    for name in ["ChildProcess", "MultiHostLauncher", "ClusterSubmission",
                 "MPISettings", "setup_mpi", "queue_status",
                 "queue_ncpus_free", "kill_job", "watch"]:
        assert hasattr(sub, name), name
