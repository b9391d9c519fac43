#!/usr/bin/env python
"""Bring-up check of the simulator's main path on one NVIDIA GPU.

    python chip_smoke.py            # phases A-D on one GPU
    python chip_smoke.py --four     # only the sharded DOT step on 4 GPUs,
                                    # against the same step unsharded

Everything runs in this one process, which holds the card; scenes are
generated structured bars written under --out (nothing is downloaded).

A  main scene: the bar17K-class twist bar (56x16x16 cells, 86K tets,
   FCR, DOT 6, warmStart 2, dt 0.025, E 1e5, nu 0.4, relTol 1e-5) in f32,
   3 warm-up frames, then 10 timed frames at h0Refresh 1.
B  plain reference on the card: A's scene for 5 frames through the CLI
   in f32 and in f64 (exact factors). Per-frame sysE and the final
   positions are held to the cross-solver bands of
   tests/test_steppers.py; at the final f64 state the energy, gradient
   and exact-path (fast=False) factor solve are evaluated in both dtypes.
C  every stepper: the nine time steppers on a bunny5K-class bar
   (24x12x12 cells, 20.7K tets) in f32, each held to an f64 projected
   Newton run (the reference's gold-standard solver, and the one the
   test suite's cross-solver tests compare DOT with) within the test
   suite's bands; one 2D scene and one Stable Neo-Hookean squash scene,
   DOT in f32 against DOT in f64. 2 frames each.
D  large-subdomain path: DOT -1 1024 on the bar135 mesh (755K tets) for
   3 frames; must take the subdomain-scan assembly, the bf16 low-memory
   band and the coarse space.

Each run prints its setup+compile seconds, steady s/frame, iterations per
frame, per-frame sysE, the process's peak device memory so far, and the
paths the System took. The last line is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Any failed check exits non-zero before it.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import time

BAR17 = (56, 16, 16)
BUNNY_BAR = (24, 12, 12)
BAR135 = (131, 31, 31)

# phase C's steppers besides DOT in blockSize mode ("DOT -1 <block>")
STEPPERS = ("Newton", "LBFGS", "LBFGSH", "LBFGSHI", "LBFGSJH 6", "ADMM",
            "ADMMDD 6", "GSDD 6")

# Bands. Cross-solver agreement per stepper family, as the test suite
# holds it on small meshes: sysE rtol (tests/test_steppers.py,
# test_admm.py, test_lbfgs_variants.py) and max|dx| for FCR
# (tests/test_steppers.py).
SYS_E_RTOL = {"GSDD": 3e-3, "LBFGSJH": 5e-3}
SYS_E_RTOL_DEFAULT = 1e-3
X_ATOL = 2e-3
# f32 against f64 at one state, every f32 dot_general at HIGHEST: the
# energy and gradient are sums over ~1e5 elements of f32 terms (relative
# error a few eps * log n); an exact Cholesky solve's relative residual is
# bounded by a small multiple of eps * cond of the equilibrated matrix.
# The gradient is a sum of terms that nearly cancel at every vertex (the
# forces of the elements around it, and the elastic against the inertial
# term), so its f32 error relative to ||g|| is eps times that
# cancellation ratio (~1e4 at the bar17K-class state).
ENERGY_RTOL_F32 = 1e-5
GRAD_RTOL_F32 = 1e-2
# ... and the f32 gradient must resolve the stopping test ||g||^2 <
# targetGRes: its error stays under a tenth of sqrt(targetGRes).
GRAD_VS_STOP_F32 = 0.1
RESID_F32 = 1e-3
RESID_F64 = 1e-10
SEED = 0   # of phase B's random right-hand side


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def rel(a, b):
    return abs(a - b) / abs(b)


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats()
    return stats.get("peak_bytes_in_use") if stats else None


def sys_e_trace(run_dir):
    with open(os.path.join(run_dir, "log.txt")) as f:
        return [float(m.group(1)) for m in re.finditer(r"sysE = (\S+)",
                                                          f.read())]


def paths(sim):
    """Which paths the System took."""
    import jax.numpy as jnp
    from dot_tpu.steppers.core import BTDFactor, CRFactor
    sy, st = sim.system, sim.state
    chol = getattr(st, "chol", None)
    factor = ("CR" if isinstance(chol, CRFactor) else
              "scan" if isinstance(chol, BTDFactor) else
              "dense" if chol is not None else "-")
    plan = getattr(sy, "plan", None)
    return {
        "banded": bool(getattr(sy, "banded", False)),
        "factor": factor,
        "scan_assembly": getattr(sy, "asm_own_idx", None) is not None,
        "bf16_band": (bool(getattr(sy, "_chunk", None))
                      and sy.apply_dtype == jnp.bfloat16),
        "coarse": bool(getattr(sy, "use_coarse", False)),
        "partitioner": getattr(plan, "partitioner", "-") or "-",
    }


def report(label, r):
    pk = r["peak_bytes"]
    log(f"[{label}] {r['name']} {r['dtype']}: setup+compile "
        f"{r['compile_s']:.3f} s, steady {r['steady_spf']:.6f} s/frame, "
        f"{r['iters_per_frame']:.2f} iters/frame, peak device memory "
        f"{'not reported' if pk is None else f'{pk / 2**30:.3f} GiB'} "
        "(process so far)")
    log(f"[{label}]   sysE {' '.join(f'{e:.10e}' for e in r['sys_e'])}")
    log(f"[{label}]   paths {json.dumps(r['paths'])}")


def release(*sims):
    """Drop the runs' device buffers and compiled programs before the
    next run (the compiled programs' trace caches hold the Systems)."""
    import jax
    for s in sims:
        s.pop("sim", None)
    gc.collect()
    jax.clear_caches()


def finish(sim, name, dtype, compile_s, steady, frames):
    import numpy as np
    return {"name": name, "dtype": dtype, "sim": sim,
            "compile_s": compile_s, "steady_spf": steady,
            "iters_per_frame": sim.inner_iter_total / max(sim.frame, 1),
            "sys_e": sys_e_trace(sim.out), "peak_bytes": peak_bytes(),
            "paths": paths(sim),
            "x": np.asarray(sim.state.x, np.float64), "frames": frames}


def run_cli(script, tag, frames, dtype, out):
    """One scene through the CLI entry point (`python -m dot_tpu 100`),
    in this process."""
    from dot_tpu.__main__ import main as cli
    t0 = time.perf_counter()
    sim = cli(["100", script, tag, "--frames", str(frames), "--dtype", dtype,
               "--save-every", str(10 ** 9), "--output-root", out])
    wall = time.perf_counter() - t0
    check(sim.frame == frames, f"{script}: ran {sim.frame}/{frames} frames")
    steady = sim.steady_spf
    name = os.path.splitext(os.path.basename(script))[0]
    return finish(sim, name, dtype, wall - steady * frames, steady, frames)


def check_finite(r):
    import numpy as np
    check(np.isfinite(r["x"]).all() and np.isfinite(r["sys_e"]).all()
          and len(r["sys_e"]) == r["frames"],
          f"{r['name']} {r['dtype']}: non-finite or missing results")


def check_agree(r, ref, sys_e_rtol, x_atol=None):
    import numpy as np
    err = max(rel(a, b) for a, b in zip(r["sys_e"], ref["sys_e"]))
    msg = (f"{r['name']} {r['dtype']} vs {ref['name']} {ref['dtype']}: "
           f"max sysE rel err {err:.3e} (limit {sys_e_rtol:g})")
    ok = err <= sys_e_rtol
    if x_atol is not None:
        dx = float(np.abs(r["x"] - ref["x"]).max())
        msg += f", max|dx| {dx:.3e} (limit {x_atol:g})"
        ok = ok and dx <= x_atol
    log("  " + msg)
    check(ok, msg)


# ---------------------------------------------------------------------------
def phase_a(out, dims=BAR17, warmup=3, frames=10):
    import jax
    import jax.numpy as jnp
    from dot_tpu.config import Config
    from dot_tpu.scenes import write_bar_scene
    from dot_tpu.sim import Simulator

    script = write_bar_scene(out, dims, stepper="DOT 6",
                             extra=["h0Refresh 1"])
    cfg = Config.load(script)
    t0 = time.perf_counter()
    sim = Simulator(cfg, os.path.join(out, "A_main_f32"),
                    dtype=jnp.float32, save_every=10 ** 9, mute=True,
                    render=False)
    sim.run(warmup)
    t1 = time.perf_counter()
    it0 = sim.inner_iter_total
    sim.run(frames)
    jax.block_until_ready(sim.state.x)
    steady = (time.perf_counter() - t1) / frames
    sim.finalize()
    r = finish(sim, f"bar{'x'.join(map(str, dims))}_twist_DOT6", "f32",
               t1 - t0 - warmup * steady, steady, warmup + frames)
    r["iters_per_frame"] = (sim.inner_iter_total - it0) / frames
    log(f"[A] {sim.mesh.n_elem} tets / {sim.mesh.n_vert} verts, "
        f"{warmup} warm-up + {frames} timed frames at h0Refresh 1")
    report("A", r)
    check_finite(r)
    check(r["iters_per_frame"] > 0, "phase A ran no iterations")
    release(r)
    return r


def _energy_grad(system, x, x_tilta, fixed):
    import jax

    @jax.jit
    def f(sy, x, xt, fx):
        F, U, s, V = sy.fsvd(x)
        return sy.energy(x, xt, s), sy.gradient(x, xt, fx, F, U, s, V)

    return f(system, x.astype(system.dtype), x_tilta.astype(system.dtype),
             fixed)


def factor_residual(system, x, fixed, seed):
    """Relative residual ||A z - b|| / ||b|| of the exact-path
    (fast=False) subdomain factorization's solve, for the equilibrated
    subdomain matrices A assembled at x and a random b; the residual is
    evaluated in f64."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from dot_tpu.steppers.core import F64, HIGHEST

    @jax.jit
    def f(sy, x, fx, b):
        _, U, s, V = sy.fsvd(x)
        Hd = sy.assemble_subdomains(sy.element_hessians(U, s, V), fx)
        L, d = sy.factorize(Hd)
        z = sy.solve_local(L, b.astype(sy._solve_dtype)).astype(F64)
        d = d.astype(F64)
        if isinstance(Hd, tuple):        # banded: (nb, P, bs, bs) blocks
            diag, sub = (h.astype(F64) for h in Hd)
            nb, P, bs = diag.shape[:3]
            dd = jnp.swapaxes(d.reshape(P, nb, bs), 0, 1)
            low = jnp.tril(diag)         # the factorization reads the
            diag = low + jnp.swapaxes(jnp.tril(diag, -1), 2, 3)  # lower
            Dn = diag / dd[..., :, None] / dd[..., None, :]
            Sn = sub / dd[1:, :, :, None] / dd[:-1, :, None, :]
            zz = jnp.swapaxes(z.reshape(P, nb, bs), 0, 1)
            y = jnp.einsum("kpij,kpj->kpi", Dn, zz, precision=HIGHEST)
            y = y.at[1:].add(jnp.einsum("kpij,kpj->kpi", Sn, zz[:-1],
                                        precision=HIGHEST))
            y = y.at[:-1].add(jnp.einsum("kpji,kpj->kpi", Sn, zz[1:],
                                         precision=HIGHEST))
            Az = jnp.swapaxes(y, 0, 1).reshape(P, nb * bs)
        else:                            # dense (P, n3, n3)
            Hn = Hd.astype(F64) / d[:, :, None] / d[:, None, :]
            Hn = 0.5 * (Hn + jnp.swapaxes(Hn, 1, 2))
            Az = jnp.einsum("pij,pj->pi", Hn, z, precision=HIGHEST)
        return jnp.linalg.norm(Az - b) / jnp.linalg.norm(b)

    b = np.random.default_rng(seed).standard_normal(
        (system.n_parts, system.n3))
    return float(f(system, x.astype(system.dtype), fixed,
                   jnp.asarray(b, F64)))


def phase_b(out, dims=BAR17, frames=5):
    import numpy as np
    from dot_tpu.scenes import write_bar_scene

    script = write_bar_scene(out, dims, stepper="DOT 6",
                             extra=["h0Refresh 1"])
    r32 = run_cli(script, "B_f32", frames, "f32", out)
    report("B", r32)
    r64 = run_cli(script, "B_f64", frames, "f64", out)
    report("B", r64)
    check_finite(r32)
    check_finite(r64)
    check_agree(r32, r64, SYS_E_RTOL_DEFAULT, X_ATOL)

    # one state, both precisions, at the real widths
    st64 = r64["sim"].state
    s32, s64 = r32["sim"].system, r64["sim"].system
    e32, g32 = _energy_grad(s32, st64.x, st64.x_tilta, st64.fixed)
    e64, g64 = _energy_grad(s64, st64.x, st64.x_tilta, st64.fixed)
    g32, g64 = np.asarray(g32, np.float64), np.asarray(g64, np.float64)
    e_err = rel(float(e32), float(e64))
    g_err = float(np.linalg.norm(g32 - g64) / np.linalg.norm(g64))
    g_stop = (float(np.linalg.norm(g32 - g64))
              / s64.target_g_res(1e-5) ** 0.5)
    res32 = factor_residual(s32, st64.x, st64.fixed, SEED)
    res64 = factor_residual(s64, st64.x, st64.fixed, SEED)
    log("[B] precision in force: f32 fields, every f32 dot_general at "
        "HIGHEST (no TF32/bf16 passes), exact factors in f32 / f64")
    for what, val, lim in (("energy f32 vs f64 rel err", e_err,
                            ENERGY_RTOL_F32),
                           ("gradient f32 vs f64 rel err (2-norm)", g_err,
                            GRAD_RTOL_F32),
                           ("gradient f32 vs f64 err / sqrt(targetGRes at "
                            "relTol 1e-5)", g_stop, GRAD_VS_STOP_F32),
                           ("exact factor solve rel residual f32", res32,
                            RESID_F32),
                           ("exact factor solve rel residual f64", res64,
                            RESID_F64)):
        log(f"[B]   {what}: {val:.3e} (limit {lim:g})")
        check(val <= lim, f"{what} {val:.3e} > {lim:g}")
    release(r32, r64)
    return r32, r64


def _scene_2d(out, stepper, resolution):
    """2D spikes stretch scene (the dim-2 pipeline's generated shape)."""
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"spikes2d_{stepper.replace(' ', '_')}.txt")
    with open(path, "w") as f:
        f.write(f"energy FCR\ntimeStepper {stepper}\nwarmStart 2\n"
                f"resolution {resolution}\nsize 1\ntime 5 0.025\n"
                "density 1000\nstiffness 100000 0.4\nscript stretch\n"
                "handleRatio 0.03\nshape spikes\n")
    return path


def phase_c_reference(out, dims=BUNNY_BAR, frames=2):
    """The f64 projected-Newton run that phase C holds every stepper to.
    (Each stepper stops somewhere inside the relTol ball; on this scene
    DOT's stopping point sits ~8e-4 above Newton's in sysE and ADMM-PD's
    ~4e-4 below it, so DOT is no reference for the others.)"""
    from dot_tpu.scenes import write_bar_scene
    script = write_bar_scene(out, dims, stepper="Newton")
    ref = run_cli(script, "C_ref_f64", frames, "f64", out)
    report("C", ref)
    check_finite(ref)
    release(ref)
    return ref


def phase_c_stepper(out, stepper, ref, dims=BUNNY_BAR, frames=2):
    from dot_tpu.scenes import write_bar_scene
    sc = write_bar_scene(out, dims, stepper=stepper)
    r = run_cli(sc, "C", frames, "f32", out)
    report("C", r)
    check_finite(r)
    check_agree(r, ref, SYS_E_RTOL.get(stepper.split()[0],
                                       SYS_E_RTOL_DEFAULT))
    release(r)


def phase_c_scene(out, kind, dims=BUNNY_BAR, frames=2, resolution_2d=2000):
    """f32 against f64 DOT on the 2D scene ("2d") or the Stable
    Neo-Hookean squash bar ("snh")."""
    from dot_tpu.scenes import write_bar_scene
    sc = (_scene_2d(out, "DOT 4", resolution_2d) if kind == "2d" else
          write_bar_scene(out, dims, stepper="DOT 6", script="squash",
                          energy="SNH"))
    r64 = run_cli(sc, "C_f64", frames, "f64", out)
    report("C", r64)
    r32 = run_cli(sc, "C_f32", frames, "f32", out)
    report("C", r32)
    check_finite(r64)
    check_finite(r32)
    check_agree(r32, r64, SYS_E_RTOL_DEFAULT)
    release(r32, r64)


def phase_c(out, dims=BUNNY_BAR, frames=2, block=1024):
    ref = phase_c_reference(out, dims, frames)
    for st in (*STEPPERS, f"DOT -1 {block}"):
        phase_c_stepper(out, st, ref, dims, frames)
    for kind in ("2d", "snh"):
        phase_c_scene(out, kind, dims, frames)


def phase_d(out, dims=BAR135, frames=3, block=1024, expect_large=True):
    from dot_tpu.scenes import write_bar_scene

    script = write_bar_scene(out, dims, stepper=f"DOT -1 {block}")
    r = run_cli(script, "D", frames, "f32", out)
    sim = r["sim"]
    log(f"[D] {sim.mesh.n_elem} tets / {sim.mesh.n_vert} verts, "
        f"{sim.system.n_parts} subdomains")
    report("D", r)
    check_finite(r)
    if expect_large:
        p = r["paths"]
        check(p["scan_assembly"] and p["bf16_band"] and p["coarse"],
              f"bar135 DOT -1 1024 missed the large-subdomain paths: {p}")
    release(r)
    return r


def four(n=4):
    import __graft_entry__ as ge
    log(f"[4] sharded DOT step on {n} devices vs unsharded on one "
        f"(bands: sysE rtol {ge.SHARDED_SYS_E_RTOL:g}, max|dx| "
        f"{ge.SHARDED_X_ATOL:g}; GPU scatter-adds are unordered, so the "
        "runs may differ in the last bits and in iteration count)")
    res = ge.sharded_dot_check(n)
    log(f"[4] {json.dumps(res)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded DOT step on 4 GPUs")
    ap.add_argument("--out", default=os.path.join("output", "chip_smoke"))
    args = ap.parse_args(argv)

    from dot_tpu import device
    dev = device.require_gpu("chip_smoke.py")
    import jax
    log(f"card: {device.card_name_and_power_limit()}")
    log(f"jax.devices(): {jax.devices()}; device_kind {dev['kind']}")
    t0 = time.perf_counter()
    if args.four:
        check(dev["count"] >= 4, f"--four needs 4 GPUs, JAX has "
              f"{dev['count']}")
        four(4)
    else:
        for name, fn in (("A", phase_a), ("B", phase_b), ("C", phase_c),
                         ("D", phase_d)):
            t = time.perf_counter()
            fn(args.out)
            log(f"[{name}] phase wall {time.perf_counter() - t:.1f} s")
    log(f"total wall {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main()
