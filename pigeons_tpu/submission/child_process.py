"""ChildProcess submission: run in a freshly spawned Python process.

Reference semantics (``src/submission/ChildProcess.jl``): serialize the
Inputs, generate a launch script that deserializes and runs them, spawn it,
wait (or not), and return a Result over the exec folder. Used by the
reference both for resource control and for the serial correctness check.

Uses: isolating a run from the parent's JAX state (a child gets its own XLA
client), pinning platform/flags via env (e.g. ``JAX_PLATFORMS=cpu``
children), and detached long runs. The child inherits the parent's
environment, so it runs on the parent's platform and shares its compile
cache (``JAX_COMPILATION_CACHE_DIR``, which also keeps XLA's autotuning
choices, so both processes compile the same reductions). It allocates
device memory on demand, so it fits on a card beside a parent that holds
most of it.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict, Optional

from .result import Result

_LAUNCH_SCRIPT = """\
import pickle
with open({inputs_path!r}, "rb") as f:
    inputs = pickle.load(f)
inputs.checkpoint = True
inputs.checkpoint_folder = {exec_folder!r}
from pigeons_tpu import PT
PT(inputs).run()
"""


@dataclass
class ChildProcess:
    """``pigeons(inputs, on=ChildProcess(...))``-style submission."""

    wait: bool = True
    env: Dict[str, str] = field(default_factory=dict)
    python: str = sys.executable

    def submit(self, inputs) -> Result:
        import dataclasses

        from ..checkpoint import next_exec_folder

        exec_folder = os.path.abspath(next_exec_folder())
        inputs = dataclasses.replace(inputs, mesh=None)
        inputs_path = os.path.join(exec_folder, ".inputs.pkl")
        with open(inputs_path, "wb") as f:
            pickle.dump(inputs, f)
        script_path = os.path.join(exec_folder, ".launch_script.py")
        with open(script_path, "w") as f:
            f.write(
                _LAUNCH_SCRIPT.format(
                    inputs_path=inputs_path,
                    exec_folder=exec_folder,
                )
            )

        import jax

        env = dict(os.environ)
        env["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
        if jax.config.jax_compilation_cache_dir:
            env["JAX_COMPILATION_CACHE_DIR"] = jax.config.jax_compilation_cache_dir
        env.update(self.env)
        # the child imports the package from the same source tree
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")

        info = os.path.join(exec_folder, "info")
        os.makedirs(info, exist_ok=True)
        with open(os.path.join(info, "stdout.txt"), "wb") as out, open(
            os.path.join(info, "stderr.txt"), "wb"
        ) as err:
            proc = subprocess.Popen(
                [self.python, script_path], env=env, stdout=out, stderr=err
            )
            if self.wait:
                code = proc.wait()
                if code != 0:
                    with open(os.path.join(info, "stderr.txt")) as f:
                        tail = f.read()[-2000:]
                    raise RuntimeError(
                        f"child process exited with {code}; stderr tail:\n{tail}"
                    )
        return Result(exec_folder=exec_folder, job_id=str(proc.pid))
