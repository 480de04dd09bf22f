"""Collective-overhead scaling proxy (VERDICT r3 item 6).

Real multi-chip hardware is unavailable in this environment, so the
measurable stand-in for BASELINE's >=80% scaling-efficiency target is:
run the SAME global program (one chain-sharded ladder over 8 virtual CPU
devices) at 1 / 2 / 4 OS processes wired by ``jax.distributed`` and time the
identical fixed-length round. The total device count, per-device work, and
numerics are identical in every configuration (results are bitwise equal by
the layout-invariance tests); the only thing that changes is how many of the
per-scan ``all_gather``/``psum`` hops cross a PROCESS boundary (gloo over
localhost) instead of staying in-process. The wall-time growth therefore
bounds the per-scan collective overhead the way DCN hops would on a pod.

Usage:
  python tools/collective_scaling.py            # driver: runs 1/2/4 procs
  python tools/collective_scaling.py worker ... # internal
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

N_CHAINS = 32
DIM = 8
N_SCANS = 256
TOTAL_DEVICES = 8


def worker(pid: int, nprocs: int, port: int) -> None:
    import jax

    if nprocs > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{port}",
            num_processes=nprocs,
            process_id=pid,
        )
    from pigeons_tpu import Inputs, PT, SliceSampler, toy_mvn_target
    from pigeons_tpu.parallel import replica_mesh

    assert len(jax.devices()) == TOTAL_DEVICES

    def timed(**kw):
        pt = PT(
            Inputs(
                target=toy_mvn_target(DIM),
                n_rounds=8,
                seed=1,
                explorer=SliceSampler(n_passes=1),
                show_report=False,
                mesh=replica_mesh(jax.devices()),
                **kw,
            )
        )
        pt.run_round(n_scans=N_SCANS)  # compile + adapt
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            pt.run_round(n_scans=N_SCANS)
            best = min(best, time.perf_counter() - t0)
        return best

    # chain-sharded: one global ladder, one all_gather + one psum per scan
    chain_s = timed(n_chains=N_CHAINS)
    # replicate-sharded control: same per-device work shape, ZERO collectives
    # in the round — isolates the process-boundary collective cost
    rep_s = timed(n_chains=N_CHAINS // TOTAL_DEVICES, n_replicates=TOTAL_DEVICES)
    if pid == 0:
        print(
            json.dumps({"nprocs": nprocs, "round_s": chain_s, "rep_round_s": rep_s}),
            flush=True,
        )


def measure(proc_counts=(1, 2, 4)) -> dict:
    """Run the proxy and return driver-artifact-ready numbers: per-scan
    boundary overhead and iso-work scaling efficiency at each process count,
    with the zero-collective replicate-sharded control (VERDICT r4 item 5 —
    these feed BENCH_r*.json via bench.py)."""
    here = os.path.abspath(__file__)
    root = os.path.dirname(os.path.dirname(here))
    results = []
    for nprocs in proc_counts:
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        procs = []
        for pid in range(nprocs):
            env = dict(os.environ)
            env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
            env["JAX_PLATFORMS"] = "cpu"
            env["XLA_FLAGS"] = (
                f"--xla_force_host_platform_device_count={TOTAL_DEVICES // nprocs}"
            )
            env.setdefault(
                "JAX_COMPILATION_CACHE_DIR", os.path.join(root, ".jax_cache")
            )
            procs.append(
                subprocess.Popen(
                    [sys.executable, here, "worker", str(pid), str(nprocs), str(port)],
                    env=env,
                    stdout=subprocess.PIPE,
                    text=True,
                )
            )
        out0 = None
        for p in procs:
            out, _ = p.communicate(timeout=900)
            if p.returncode != 0:
                raise SystemExit(f"worker rc={p.returncode}")
            for line in reversed(out.strip().splitlines()):
                try:
                    out0 = json.loads(line)
                    break
                except json.JSONDecodeError:
                    continue
        results.append(out0)
        print(
            f"P={out0['nprocs']}: chain-sharded {out0['round_s']:.3f}s "
            f"({out0['round_s'] / N_SCANS * 1e3:.3f} ms/scan), "
            f"replicate-sharded control {out0['rep_round_s']:.3f}s"
        )
    base = results[0]["round_s"]
    rep_base = results[0]["rep_round_s"]
    out = {"n_scans": N_SCANS, "runs": results}
    for r in results:
        p = r["nprocs"]
        over = (r["round_s"] - base) / N_SCANS * 1e6
        eff = base / r["round_s"] * 100.0
        rep_eff = rep_base / r["rep_round_s"] * 100.0
        out[f"eff_p{p}_pct"] = round(eff, 1)
        out[f"overhead_us_per_scan_p{p}"] = round(max(over, 0.0), 1)
        out[f"control_eff_p{p}_pct"] = round(rep_eff, 1)
        print(
            f"P={p}: collective path {eff:.1f}% iso-work efficiency "
            f"({max(over, 0):.0f} us/scan boundary overhead); "
            f"no-collective control {rep_eff:.1f}%"
        )
    return out


def driver() -> None:
    measure()


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    else:
        driver()
