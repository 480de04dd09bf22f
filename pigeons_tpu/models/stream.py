"""Stream-protocol targets: worker processes explored over stdin/stdout.

Parity with the reference's ``StreamTarget`` (``src/targets/StreamTarget.jl``):
one worker process per replica, communicating via a text protocol so that
models written in ANY language can be tempered —

  * ``log_potential(0.6)\\n``  -> worker answers ``response(-124.23)\\n``
    (the joint log density at ``beta = 0.6``);
  * ``call_sampler!(0.4)\\n``  -> worker runs one round of local exploration
    at ``beta = 0.4`` against its own state, then answers ``response()\\n``.

The worker owns the state and the path; the device side only ever sees the
log-density scalar. Exactly as in the reference, the explorer and the
reference-chain iid regeneration BOTH delegate to ``call_sampler!`` (the
worker detects ``beta == 0``; ``StreamTarget.jl:68-96``), swaps exchange chain
indices (betas) rather than states, and the worker's seed is derived from the
master seed by replica index (``java_seed``, ``StreamTarget.jl:100``).

Device mapping: this is the documented slow compatibility path (SURVEY §7.4) —
each evaluation round-trips device -> host -> worker pipe. The host callback
is BATCHED: all replicas' requests arrive as one ``[n_chains]`` block per
scan phase and fan out to the workers from a thread pool, so wall time per
scan is one worker round-trip (~0.1 ms/cmd), not ``n_chains`` of them.
``n_replicates > 1`` and replica meshes are rejected for stream targets.

``BlangTarget`` / ``TreePPLTarget`` build the worker commands for the two
ecosystems the reference bridges (``src/targets/BlangTarget.jl:14-42``,
``src/targets/TreePPLTarget.jl``). A pure-Python demo worker lives in
``pigeons_tpu.models.stream_worker_demo`` (used by the tests and as the
specification-by-example of the worker side of the protocol).
"""

from __future__ import annotations

import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .target import Reference, Target


def java_seed(seed: int, replica_index: int) -> int:
    """Positive 63-bit worker seed derived from (master seed, replica index) —
    the analogue of the reference's per-replica rng split passed to the worker
    (``StreamTarget.jl:100``: drop the sign bit for Java compatibility)."""
    # splitmix64-style scramble, stays deterministic and layout-independent
    z = (seed * 0x9E3779B97F4A7C15 + replica_index + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 1


class _Worker:
    """One child process + the stdin/stdout protocol (expect-style scan for
    ``response(`` ... ``)``, tolerating informational prints in between)."""

    def __init__(self, command: Sequence[str], echo: bool = False, env=None):
        self.proc = subprocess.Popen(
            list(command),
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
            bufsize=1,
            env=env,
        )
        self.lock = threading.Lock()
        self.echo = echo

    def invoke(self, request: str) -> str:
        """Send one command line, scan stdout until ``response(...)``, return
        the text between the parentheses."""
        with self.lock:
            assert self.proc.stdin is not None and self.proc.stdout is not None
            self.proc.stdin.write(request + "\n")
            self.proc.stdin.flush()
            buf = ""
            while True:
                ch = self.proc.stdout.read(1)
                if ch == "":
                    raise RuntimeError(
                        f"stream worker exited (rc={self.proc.poll()}) while "
                        f"answering {request!r}"
                    )
                buf += ch
                start = buf.find("response(")
                if start < 0:
                    continue
                end = buf.find(")", start)
                if end < 0:
                    continue
                if self.echo and start > 0:
                    print(buf[:start], end="")
                return buf[start + len("response(") : end]

    def close(self) -> None:
        try:
            if self.proc.stdin is not None:
                self.proc.stdin.close()
            self.proc.terminate()
            self.proc.wait(timeout=5)
        except Exception:
            try:
                self.proc.kill()
            except Exception:
                pass


class _WorkerPool:
    """Lazily-spawned workers, one per replica index, driven concurrently."""

    def __init__(
        self,
        command_builder: Callable[[int], Sequence[str]],
        env_builder: Optional[Callable[[int], dict]] = None,
    ):
        self.command_builder = command_builder
        self.env_builder = env_builder  # replica index -> process environment
        self.workers: dict[int, _Worker] = {}
        self.pool: Optional[ThreadPoolExecutor] = None
        self._spawn_lock = threading.Lock()

    def worker(self, i: int) -> _Worker:
        with self._spawn_lock:
            if i not in self.workers:
                # replica 1's informational output is echoed, as in the
                # reference (StreamTarget.jl:118-122)
                env = self.env_builder(i) if self.env_builder is not None else None
                self.workers[i] = _Worker(
                    self.command_builder(i), echo=(i == 0), env=env
                )
            return self.workers[i]

    def invoke_batch(self, requests: list[str]) -> list[str]:
        if self.pool is None:
            self.pool = ThreadPoolExecutor(
                max_workers=min(64, max(1, len(requests)))
            )
        futures = [
            self.pool.submit(self.worker(i).invoke, req)
            for i, req in enumerate(requests)
        ]
        return [f.result() for f in futures]

    def close(self) -> None:
        for w in self.workers.values():
            w.close()
        self.workers.clear()
        if self.pool is not None:
            self.pool.shutdown(wait=False)
            self.pool = None


class StreamPath:
    """Path whose interpolation lives inside the workers: only beta crosses
    the bridge (reference ``StreamPath``/``StreamPotential``,
    ``StreamTarget.jl:54-63``)."""

    has_iid_reference = False

    def __init__(self, target: "StreamTarget"):
        self._target = target

    def log_density(self, x, beta):
        del x  # worker routing is by vmap lane (= replica index)
        target = self._target

        def host(beta_b, _lp_guard):
            b = np.atleast_1d(np.asarray(beta_b, dtype=np.float64))
            reqs = [f"log_potential({float(v)!r})" for v in b]
            out = np.array(
                [float(s) for s in target.pool.invoke_batch(reqs)], np.float32
            )
            return out.reshape(np.shape(beta_b))

        return jax.pure_callback(
            host,
            jax.ShapeDtypeStruct(jnp.shape(beta), jnp.float32),
            beta,
            jnp.float32(0.0),
            vmap_method="expand_dims",
        )


class StreamExplorer:
    """Delegates exploration to the workers: one ``call_sampler!(beta)`` per
    replica per scan, then one ``log_potential(beta)`` refresh. Matches the
    reference's ``step!(explorer::StreamTarget, ...)`` =
    ``call_sampler!(find_log_potential(...), state)`` (StreamTarget.jl:68-73).
    """

    extra_names: tuple = ()

    def __init__(self, target: "StreamTarget"):
        self._target = target

    def init_state(self, n_chains: int, dim: int):
        return ()

    def adapt(self, state, reduced, round_idx: int):
        return state

    def step(self, key, x, lp0, lp_fn, beta, chain_params, scan_idx):
        from ..ops.base import StepOut, _zero_stats

        del key, chain_params, scan_idx
        target = self._target

        def host(beta_b, lp_b):
            b = np.atleast_1d(np.asarray(beta_b, dtype=np.float64))
            target.pool.invoke_batch([f"call_sampler!({float(v)!r})" for v in b])
            out = np.array(
                [
                    float(s)
                    for s in target.pool.invoke_batch(
                        [f"log_potential({float(v)!r})" for v in b]
                    )
                ],
                np.float32,
            )
            return out.reshape(np.shape(beta_b))

        # lp0 is an argument so each scan's sampler call is data-dependent on
        # the previous scan's (XLA cannot reorder or elide the worker calls)
        lp_new = jax.pure_callback(
            host,
            jax.ShapeDtypeStruct(jnp.shape(beta), jnp.float32),
            beta,
            lp0,
            vmap_method="expand_dims",
        )
        a, n, s = _zero_stats()
        return StepOut(x, lp_new, a + 1.0, n + 1.0, s + 1.0)


class StreamTarget(Target):
    """Temper a model implemented by external worker processes.

    ``command_builder(replica_index) -> argv list``. Use :func:`java_seed`
    inside the builder to pass a per-replica seed to the worker. The device
    side state is a single dummy coordinate; traces/moments therefore carry
    only the log density, as in the reference (``StreamState.jl:23-24``:
    ``LogPotentialExtractor``).
    """

    dim = 1
    host_evaluated = True

    def __init__(
        self,
        command_builder: Callable[[int], Sequence[str]],
        env_builder: Optional[Callable[[int], dict]] = None,
    ):
        self._command_builder = command_builder
        self._env_builder = env_builder
        self.pool = _WorkerPool(command_builder, env_builder)

    # -- Target interface ---------------------------------------------------
    def log_density(self, x):
        return StreamPath(self).log_density(x, jnp.float32(1.0))

    def default_reference(self) -> Reference:
        # the worker owns the path; Reference exists only for interface
        # completeness and is never evaluated (create_path is overridden)
        return Reference(log_density=lambda x: jnp.float32(0.0), sample_iid=None)

    def create_path(self, reference):
        del reference
        return StreamPath(self)

    def default_explorer(self):
        return StreamExplorer(self)

    def initialization(self, key):
        del key
        return jnp.zeros((1,), jnp.float32)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Dispose of the worker processes (reference
        ``kill_child_processes``, ``StreamTarget.jl:28-36``)."""
        self.pool.close()

    def __getstate__(self):
        return {
            "_command_builder": self._command_builder,
            "_env_builder": self._env_builder,
        }

    def __setstate__(self, state):
        self._command_builder = state["_command_builder"]
        self._env_builder = state.get("_env_builder")
        self.pool = _WorkerPool(self._command_builder, self._env_builder)


def kill_child_processes(pt) -> None:
    """Close the worker pool of a finished run (reference
    ``StreamTarget.jl:28-36``)."""
    target = pt.inputs.target
    if isinstance(target, StreamTarget):
        target.close()


# ---------------------------------------------------------------------------
# ecosystem command builders (reference BlangTarget.jl / TreePPLTarget.jl)
# ---------------------------------------------------------------------------


class BlangTarget(StreamTarget):
    """A Blang (JVM) model speaking the Pigeons bridge protocol
    (reference ``src/targets/BlangTarget.jl:14-42``). ``command`` is the
    pre-compiled model invocation, e.g. ``["java", "pkg.MyModel", ...]``;
    the bridge engine flags and the per-replica seed are appended."""

    def __init__(self, command: Sequence[str], seed: int = 1):
        base = list(command)

        def build(replica_index: int):
            return base + [
                "--experimentConfigs.resultsHTMLPage",
                "false",
                "--experimentConfigs.saveStandardStreams",
                "false",
                "--engine",
                "blang.engines.internals.factories.Pigeons",
                "--engine.random",
                str(java_seed(seed, replica_index)),
            ]

        super().__init__(build)


class TreePPLTarget(StreamTarget):
    """A compiled TreePPL binary speaking the protocol (reference
    ``src/targets/TreePPLTarget.jl``); the seed rides the ``PPL_SEED`` env
    var (``TreePPLTarget.jl:166-167``)."""

    def __init__(self, command: Sequence[str], seed: int = 1):
        base = list(command)
        self._seed = seed

        def build(replica_index: int):
            return base

        def env(replica_index: int):
            # the seed rides the PPL_SEED env var (TreePPLTarget.jl:166-167)
            e = dict(os.environ)
            e["PPL_SEED"] = str(java_seed(seed, replica_index))
            return e

        super().__init__(build, env)
