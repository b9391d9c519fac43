#!/usr/bin/env python
"""Multi-chip scaling audit: compile the production-shape banded
DOT step (fixed mesh, fixed n_parts=8 partition) sharded over 2/4/8
virtual devices and report, per device count, the per-device memory,
flops, and — the number that decides whether the design scales over
the device interconnect — the collective-traffic bytes the SPMD
partitioner inserted (the replicated-vertex gradient reduction is the
dominant site; see docs/MULTICHIP.md). Holding the partition
constant makes the rows apples-to-apples: same H0, same convergence,
only the device axis varies.

Runs each device count in a subprocess on the CPU backend (virtual
host devices): these are counts from shapes, not times.
Usage:  python tools/weak_scaling.py [out.json]
"""

import json
import os
import subprocess
import sys

CHILD = r"""
import json
import sys

import jax
import jax.numpy as jnp

import __graft_entry__ as ge
from dot_tpu import parallel
from dot_tpu.steppers.core import F64

n = int(sys.argv[1])
# n_parts is held CONSTANT (8) across device counts so the rows are a
# controlled scaling experiment — same H0, same iteration counts, only
# the sharding varies. (Earlier revisions set n_parts = n_devices, which
# conflated partition count with device count: the 2/4/8 rows ran
# different preconditioners, inner_iters 2/5/11.)
system, stepper = ge._build_scene(n_parts=8, nx=24, ny=12, nz=12,
                                  band_bs_unit=384, band_min_nb=3)
state = stepper.init_state()
tol = jnp.asarray(system.target_g_res(1e-5), F64)
mesh = parallel.device_mesh(n)
st_sh, state_sh = parallel.shard_for_step(stepper, state, mesh)
compiled = jax.jit(type(stepper)._step_impl).lower(
    st_sh, state_sh, tol).compile()
new_state, (stats, _) = compiled(st_sh, state_sh, tol)
jax.block_until_ready(new_state.x)

rec = {"n_devices": n, "n_elem": int(system.mesh.n_elem),
       "n_vert": int(system.mesh.n_vert),
       "n_elem_padded": int(system.n_elem_p),
       "inner_iters": int(stats.inner_iters),
       "collectives": parallel.collective_traffic(compiled)}
try:
    ma = compiled.memory_analysis()
    rec["per_device_mem_mib"] = {
        "args": round(ma.argument_size_in_bytes / 2**20, 2),
        "output": round(ma.output_size_in_bytes / 2**20, 2),
        "temp": round(ma.temp_size_in_bytes / 2**20, 2)}
except Exception:
    pass
try:
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    rec["per_device_flops"] = float(ca.get("flops", 0.0))
except Exception:
    pass
print("WEAK_SCALING_JSON " + json.dumps(rec))
"""


def main():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_path = sys.argv[1] if len(sys.argv) > 1 else None
    results = []
    for n in (2, 4, 8):
        env = dict(os.environ)
        env["PYTHONPATH"] = repo
        env["JAX_PLATFORMS"] = "cpu"
        flags = [f for f in env.get("XLA_FLAGS", "").split()
                 if "host_platform_device_count" not in f]
        env["XLA_FLAGS"] = " ".join(
            flags + [f"--xla_force_host_platform_device_count={n}"])
        res = subprocess.run([sys.executable, "-c", CHILD, str(n)],
                             env=env, cwd=repo, capture_output=True,
                             text=True)
        rec = None
        for line in res.stdout.splitlines():
            if line.startswith("WEAK_SCALING_JSON "):
                rec = json.loads(line[len("WEAK_SCALING_JSON "):])
        if rec is None:
            sys.stderr.write(res.stdout + res.stderr)
            raise RuntimeError(f"weak-scaling child n={n} failed")
        results.append(rec)
        tot = rec["collectives"]["total"]
        print(f"n={n}: {rec['n_elem_padded'] // n} elems/device, "
              f"collectives {tot['count']} sites "
              f"{tot['bytes'] / 2**20:.2f} MiB, "
              f"flops/device {rec.get('per_device_flops', 0):.3e}")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
