"""Explorer combinators: random mixtures and deterministic compositions.

Reference: ``src/explorers/Mix.jl`` (pick one sub-explorer uniformly per
step) and ``src/explorers/Compose.jl`` (run all sub-explorers in sequence).
Adaptation and recorder plumbing recurse into the components.

Batched note: ``Mix``'s per-replica uniform choice puts a ``lax.switch``
with a BATCHED index inside the vmapped step — XLA must then execute every
branch on masked lanes, so a K-component Mix costs ~the SUM of its
components per scan. :class:`ScanMix` is the mitigation: it
cycles components ACROSS scans (one component per scan, all replicas), so
the switch index stays a scalar under vmap and exactly ONE branch executes
— the ideal mixture cost, layout-invariant by construction. Statistically
it is the systematic-scan analogue of Mix's random scan (each chain still
alternates all components; any fixed component schedule independent of the
state preserves the target). Prefer ``ScanMix`` (or ``Compose``) on hot
paths; ``Mix`` remains for reference-faithful random mixing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .base import Explorer, StepOut


class Compose(Explorer):
    """Deterministic composition: run each component in order."""

    def __init__(self, *explorers):
        self.explorers = tuple(explorers)
        self.extra_names = tuple(
            f"{i}_{name}" for i, e in enumerate(self.explorers) for name in e.extra_names
        )
        self._extra_slices = []
        off = 0
        for e in self.explorers:
            k = len(e.extra_names)
            self._extra_slices.append((off, k))
            off += k

    def init_state(self, n_chains: int, dim: int):
        return tuple(e.init_state(n_chains, dim) for e in self.explorers)

    def needs_online_moments(self) -> bool:
        return any(e.needs_online_moments() for e in self.explorers)

    def adapt(self, state, reduced, round_idx: int):
        out = []
        for e, s, (off, k) in zip(self.explorers, state, self._extra_slices):
            view = reduced
            if k:
                view = reduced._replace(
                    extra_mean=reduced.extra_mean[:, off : off + k],
                    extra_n=reduced.extra_n[:, off : off + k],
                )
            out.append(e.adapt(s, view, round_idx))
        return tuple(out)

    def step(self, key, x, lp0, lp_fn, beta, chain_params, scan_idx) -> StepOut:
        z = jnp.zeros((), jnp.float32)
        a_s = a_n = ns = z
        ex_s, ex_n = [], []
        lp = lp0
        for i, (e, cp) in enumerate(zip(self.explorers, chain_params)):
            out = e.step(jax.random.fold_in(key, i), x, lp, lp_fn, beta, cp, scan_idx)
            x, lp = out.x, out.lp
            a_s, a_n, ns = a_s + out.accept_sum, a_n + out.accept_n, ns + out.n_steps
            if len(e.extra_names):
                ex_s.append(out.extras_sum)
                ex_n.append(out.extras_n)
        extras_sum = jnp.concatenate(ex_s) if ex_s else ()
        extras_n = jnp.concatenate(ex_n) if ex_n else ()
        return StepOut(x, lp, a_s, a_n, ns, extras_sum, extras_n)


class Mix(Explorer):
    """Uniform random mixture: pick one component per step
    (reference ``Mix.jl:23``).

    Components with extra recorders get FIXED slots in the concatenated
    extras vector (as in :class:`Compose`); per step only the selected
    component's slots receive mass — its counts are masked by the selection,
    so per-chain means stay well-defined (the reference records into a
    per-component GroupBy the same way)."""

    def __init__(self, *explorers):
        self.explorers = tuple(explorers)
        self.extra_names = tuple(
            f"{i}_{name}" for i, e in enumerate(self.explorers) for name in e.extra_names
        )
        self._extra_slices = []
        off = 0
        for e in self.explorers:
            k = len(e.extra_names)
            self._extra_slices.append((off, k))
            off += k

    def init_state(self, n_chains: int, dim: int):
        return tuple(e.init_state(n_chains, dim) for e in self.explorers)

    def needs_online_moments(self) -> bool:
        return any(e.needs_online_moments() for e in self.explorers)

    def adapt(self, state, reduced, round_idx: int):
        out = []
        for e, s, (off, k) in zip(self.explorers, state, self._extra_slices):
            view = reduced
            if k:
                view = reduced._replace(
                    extra_mean=reduced.extra_mean[:, off : off + k],
                    extra_n=reduced.extra_n[:, off : off + k],
                )
            out.append(e.adapt(s, view, round_idx))
        return tuple(out)

    def step(self, key, x, lp0, lp_fn, beta, chain_params, scan_idx) -> StepOut:
        k_pick, k_step = jax.random.split(key)
        idx = jax.random.randint(k_pick, (), 0, len(self.explorers))
        K = len(self.extra_names)

        def make_branch(i):
            def branch(args):
                x, lp0 = args
                out = self.explorers[i].step(
                    k_step, x, lp0, lp_fn, beta, chain_params[i], scan_idx
                )
                if K:
                    off, k = self._extra_slices[i]
                    es = jnp.zeros(K, jnp.float32)
                    en = jnp.zeros(K, jnp.float32)
                    if k:
                        es = es.at[off : off + k].set(out.extras_sum)
                        en = en.at[off : off + k].set(out.extras_n)
                else:
                    es, en = (), ()
                return StepOut(
                    out.x, out.lp, out.accept_sum, out.accept_n, out.n_steps,
                    es, en,
                )

            return branch

        return lax.switch(idx, [make_branch(i) for i in range(len(self.explorers))], (x, lp0))


class ScanMix(Mix):
    """Systematic-scan mixture: component ``scan_idx % K`` runs on ALL
    replicas this scan, cycling deterministically across scans.

    The selection index is a scalar function of the (non-vmapped) scan
    counter, so under vmap the ``lax.switch`` stays a real branch and only
    the selected component executes — K times cheaper than :class:`Mix`'s
    per-replica random choice, with identical per-chain component coverage
    over a round (each chain runs every component every K scans). Any
    state-independent component schedule preserves the target, exactly as
    the reference argues for its deterministic ``Compose``
    (``src/explorers/Compose.jl``); layout-invariant by construction since
    the schedule depends on nothing but the scan index."""

    def step(self, key, x, lp0, lp_fn, beta, chain_params, scan_idx) -> StepOut:
        K_comp = len(self.explorers)
        idx = jnp.asarray(scan_idx, jnp.int32) % K_comp
        K = len(self.extra_names)

        def make_branch(i):
            def branch(args):
                x, lp0 = args
                out = self.explorers[i].step(
                    key, x, lp0, lp_fn, beta, chain_params[i], scan_idx
                )
                if K:
                    off, k = self._extra_slices[i]
                    es = jnp.zeros(K, jnp.float32)
                    en = jnp.zeros(K, jnp.float32)
                    if k:
                        es = es.at[off : off + k].set(out.extras_sum)
                        en = en.at[off : off + k].set(out.extras_n)
                else:
                    es, en = (), ()
                return StepOut(
                    out.x, out.lp, out.accept_sum, out.accept_n, out.n_steps,
                    es, en,
                )

            return branch

        return lax.switch(idx, [make_branch(i) for i in range(K_comp)], (x, lp0))
