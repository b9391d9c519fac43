"""Frame-loop simulator driver: owns the output-files contract of the
reference binary (reference: main.cpp:92-132 proceedOptimization,
main.cpp:318-358 saveInfo, Optimizer.cpp:1095-1162 saveStatus).

Per run directory:
  config.txt        round-tripped config
  <n>.obj           surface mesh per step (compacted surface vertices)
  status<n>         restartable plain-text state (timestep/position/
                    velocity/dx_Elastic — same token format as reference)
  iterStats.txt     per-iteration rows (step, alpha, E, ||g||^2)
  info.txt          mesh size, iteration totals, timing buckets
  log.txt           tolerances, inner iter counts, sysE per step
  finalResult_mesh.msh
"""

from __future__ import annotations

import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from . import io as meshio
from . import partition, scripts
from .config import Config
from .mesh import Mesh
from .steppers import (System, DOTStepper, NewtonStepper, LBFGSPD, LBFGSH,
                       LBFGSHI, LBFGSJH, ADMMPDStepper, GSDDStepper,
                       ADMMDDStepper)

DEFAULT_REL_TOL = 1.0e-5   # README: "1e-5 CN ... used in all experiments"


class Timer:
    """Named-activity wall-clock accumulator (reference: Timer.hpp)."""

    def __init__(self):
        self.acc = {}
        self._cur = None
        self._t0 = None

    def start(self, name):
        self.stop()
        self._cur = name
        self._t0 = time.perf_counter()

    def stop(self):
        if self._cur is not None:
            self.acc[self._cur] = (self.acc.get(self._cur, 0.0)
                                   + time.perf_counter() - self._t0)
            self._cur = None

    def report(self):
        total = sum(self.acc.values())
        lines = [f"{k} {v:.6f}" for k, v in self.acc.items()]
        lines.append(f"total {total:.6f}")
        return "\n".join(lines)


def device_memory_limit():
    """Bytes the allocator may hand out on the first device, or None
    where the backend reports no limit (the CPU)."""
    stats = jax.devices()[0].memory_stats()
    return stats.get("bytes_limit") if stats else None


def _check_matrix_budget(plan, dtype, stepper, limit_bytes=None):
    """Refuse early with a clear message instead of letting the device
    allocator OOM mid-compile. With an RCM-banded plan the whole-mesh
    matrix is block-tridiagonal, O(n * bandwidth) — large meshes that
    would need an O((3nV)^2) dense factor become feasible; only truly
    huge bands are refused. (Even larger meshes: use DOT/GSDD/ADMMDD,
    e.g. 'timeStepper DOT -1 1024'.) The limit is the device's own
    allocator limit; a device that reports none (the CPU, whose memory
    is the host's) is not checked."""
    if limit_bytes is None:
        limit_bytes = device_memory_limit()
        if limit_bytes is None:
            return
    itemsize = 4 if dtype == jnp.float32 else 8
    if plan.band_nb >= 3:
        # the scan-major BTD factorization peaks at ~3x the banded
        # storage (assembly flat + equilibrated scan inputs + stacked
        # Linv/coupling outputs); 5x leaves headroom for the rest of the
        # step program
        blocks = plan.n_parts * (2 * plan.band_nb - 1)
        need = 5 * blocks * plan.band_bs ** 2 * itemsize
        kind = (f"{plan.n_parts} x {plan.band_nb}-block tridiagonal "
                f"(bs={plan.band_bs})")
    else:
        need = plan.n_parts * plan.n3 ** 2 * itemsize * 3
        kind = f"{plan.n_parts} x dense {plan.n3}^2"
    if need > limit_bytes:
        raise MemoryError(
            f"timeStepper {stepper} needs {kind} matrices: "
            f"{need / 2**30:.1f} GiB exceeds the device's "
            f"{limit_bytes / 2**30:.1f} GiB. Use a decomposed "
            "stepper (DOT/GSDD/ADMMDD), e.g. 'timeStepper DOT -1 1024'.")


def pick_dtype(name=None):
    if name == "f64":
        return jnp.float64
    if name == "f32":
        return jnp.float32
    return jnp.float64 if jax.default_backend() == "cpu" else jnp.float32


class Simulator:
    def __init__(self, cfg: Config, output_dir: str, dtype=None,
                 search_dirs=(), save_every=1, mute=False, profile=False,
                 render=True, viewer=False):
        self.cfg = cfg
        self.out = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.save_every = save_every
        self.mute = mute
        self.profile = profile
        self.render = render
        self.timer = Timer()

        self.timer.start("load")
        self.mesh = Mesh.from_config(cfg, search_dirs)
        self.script_data = scripts.init_script(self.mesh, cfg.script)
        self.mesh.fixed_mask = self.script_data.fixed0.copy()

        # surface output maps (compacted surface vertices, main.cpp:800-834)
        sf = self.mesh.SF
        surf_verts = np.unique(sf.ravel())
        remap = np.full(self.mesh.n_vert, -1, np.int64)
        remap[surf_verts] = np.arange(len(surf_verts))
        self._surf_verts = surf_verts
        self._surf_faces = remap[sf]

        self.timer.start("partition+compile")
        dtype = dtype if dtype is not None else pick_dtype()
        # applyDtype config key -> System.apply_dtype (ADVICE r2: an
        # explicit opt-out of the bf16 H0-apply default for f32 runs)
        adt = {"": None, "f32": jnp.float32, "f64": jnp.float64,
               "bf16": jnp.bfloat16}[cfg.apply_dtype]
        stepper_t = cfg.time_stepper
        if stepper_t in ("DOT", "GSDD"):
            n_parts = partition.partition_amt_from_config(cfg, self.mesh.n_vert)
            plan = partition.build_plan(self.mesh, n_parts,
                                        scheme=cfg.partition_scheme)
            self.system = System(self.mesh, cfg, plan, dtype=dtype,
                                 apply_dtype=adt)
            cls = GSDDStepper if stepper_t == "GSDD" else DOTStepper
            if stepper_t == "GSDD":
                # GSDD's sequential sweep never applies the coarse
                # correction (its per-subdomain solves bypass h0_apply),
                # so rebuilding the (6P)^2 coarse factor every
                # _rebuild_h0 would be pure waste on this path.
                self.system.use_coarse = False
            self.stepper = cls(self.system, self.script_data,
                               warm_start_opt=cfg.warm_start)
        elif stepper_t == "Newton":
            plan = partition.build_plan(self.mesh, 1)
            _check_matrix_budget(plan, dtype, stepper_t)
            self.system = System(self.mesh, cfg, plan, dtype=dtype,
                                 apply_dtype=adt)
            self.stepper = NewtonStepper(self.system, self.script_data,
                                         warm_start_opt=cfg.warm_start)
        elif stepper_t == "ADMMDD":
            n_parts = partition.partition_amt_from_config(cfg, self.mesh.n_vert)
            # banded (RCM block-tridiagonal) local factors when profitable:
            # the augmented local Hessian (own elements + W) factorizes and
            # solves on the band, replacing the dense (P, n3, n3) factor
            # that dominated ADMM-DD's per-iteration cost; W stays compact
            plan = partition.build_plan(self.mesh, n_parts, own_plan=True,
                                        scheme=cfg.partition_scheme)
            ap = partition.build_admm_dd_plan(self.mesh, plan)
            self.system = System(self.mesh, cfg, plan, dtype=dtype,
                                 apply_dtype=adt)
            self.stepper = ADMMDDStepper(self.system, self.script_data, ap,
                                         warm_start_opt=cfg.warm_start)
        elif stepper_t == "ADMM":
            self.system = System(self.mesh, cfg, None, dtype=dtype,
                                 apply_dtype=adt)
            self.stepper = ADMMPDStepper(self.system, self.script_data,
                                         max_iter=cfg.max_iter_apd)
        elif stepper_t == "LBFGS":
            self.system = System(self.mesh, cfg, None, dtype=dtype,
                                 apply_dtype=adt)
            self.stepper = LBFGSPD(self.system, self.script_data,
                                   warm_start_opt=cfg.warm_start)
        elif stepper_t in ("LBFGSH", "LBFGSHI"):
            plan = partition.build_plan(self.mesh, 1)
            _check_matrix_budget(plan, dtype, stepper_t)
            fdt = jnp.bfloat16 if stepper_t == "LBFGSHI" else None
            self.system = System(self.mesh, cfg, plan, dtype=dtype,
                                 factor_dtype=fdt, apply_dtype=adt)
            cls = LBFGSHI if stepper_t == "LBFGSHI" else LBFGSH
            self.stepper = cls(self.system, self.script_data,
                               warm_start_opt=cfg.warm_start)
        elif stepper_t == "LBFGSJH":
            n_parts = partition.partition_amt_from_config(cfg, self.mesh.n_vert)
            plan = partition.build_node_plan(self.mesh, n_parts)
            self.system = System(self.mesh, cfg, plan, dtype=dtype,
                                 apply_dtype=adt)
            self.stepper = LBFGSJH(self.system, self.script_data,
                                   warm_start_opt=cfg.warm_start)
        else:
            raise NotImplementedError(
                f"timeStepper {stepper_t} not implemented yet "
                "(available: DOT, GSDD, Newton, ADMM, ADMMDD, LBFGS, LBFGSH, "
                "LBFGSHI, LBFGSJH)")

        # subdomain-label debug outputs for the decomposed steppers
        # (reference: ADMMDDTimeStepper.cpp:375-442 writes these at ctor)
        if (getattr(self.system, "plan", None) is not None
                and getattr(self.system.plan, "part", None) is not None
                and self.system.plan.n_parts > 1):
            meshio.write_partition_debug(output_dir, self.mesh,
                                         self.system.plan.part)

        self.state = self.stepper.init_state()
        self.frame = 0
        self.frame_amt = int(cfg.duration / cfg.dt)
        self.inner_iter_total = 0
        self.ls_total = 0

        # H0 refresh policy (config key h0Refresh; see Config.h0_refresh).
        # Applies to the quasi-Newton steppers only — Newton refactorizes
        # per iteration and the ADMM steppers own their factor lifetimes.
        from .steppers.quasi_newton import QuasiNewtonStepper
        self._h0_policy = (cfg.h0_refresh
                           if isinstance(self.stepper, QuasiNewtonStepper)
                           else 1)
        self._fsr = 0            # steps since the H0 factors were rebuilt
        self._it_base = None     # adaptive: best lagged iters/frame in epoch
        self._base_from_frame = 0  # frames before this ran a stale factor
        self._refresh_req = False

        if cfg.restart:
            self._load_status(cfg.status_path)
        self.timer.stop()

        cfg.save(os.path.join(output_dir, "config.txt"))
        self._iter_stats = open(os.path.join(output_dir, "iterStats.txt"), "w")
        self._log = open(os.path.join(output_dir, "log.txt"), "w")

        # interactive HTTP viewer (reference mode 0's GLFW window,
        # main.cpp:955-978; see viewer.py)
        self.viewer = None
        if viewer:
            from .viewer import LiveViewer, surface_face_parts
            part = getattr(getattr(self.system, "plan", None), "part", None)
            fp = (surface_face_parts(self.mesh, part)
                  if part is not None else None)
            self.viewer = LiveViewer(self._surf_faces, face_part=fp,
                                     zoom=cfg.zoom)
            self.viewer.submit(self.mesh.V[self._surf_verts], 0)
            if not mute:
                print(f"viewer: {self.viewer.url}")

    # ------------------------------------------------------------------
    def _rel_tol(self, frame):
        tol = self.cfg.tol
        if not tol:
            return DEFAULT_REL_TOL
        return tol[min(frame, len(tol) - 1)]

    def run(self, frames=None, pipeline=8):
        """Advance `frames` frames. Steps are dispatched asynchronously and
        stats downloads trail up to `pipeline` frames behind, so the
        device->host transfers overlap with in-flight step compute
        instead of making the host wait for the device after every
        frame."""
        n = self.frame_amt if frames is None else min(frames,
                                                      self.frame_amt - self.frame)
        t_begin = time.perf_counter()
        t_warm = None
        pending = []
        for i in range(n):
            if self.viewer is not None:
                self.viewer.wait_if_paused()
            if self.frame % self.save_every == 0:
                self.timer.start("save")
                while pending:
                    self._record(*pending.pop(0))
                self.save_status()
                self.timer.stop()
            self.timer.start("step")
            rel = self._rel_tol(self.frame)
            tol = self.system.target_g_res(rel)
            if self._h0_policy == 1:
                self.state, (stats, sys_e) = self.stepper.step(self.state,
                                                               rel)
            else:
                # end-of-step rebuild gate: the first frames always
                # refresh so the adaptive baseline is measured against
                # a fresh H0; stats arrive `pipeline` frames late, so
                # the adaptive trigger is a lagged regression signal
                # backed by a hard 32-frame cap
                if self._h0_policy > 1:
                    refresh = self._fsr + 1 >= self._h0_policy
                else:
                    refresh = self._refresh_req or self._fsr + 1 >= 32
                refresh = refresh or self.frame < 3
                self.state, (stats, sys_e) = self.stepper.step(
                    self.state, rel, refresh=refresh)
                if refresh:
                    self._fsr = 0
                    self._refresh_req = False
                    # re-baseline: lagged stats from frames before this
                    # refresh reflect the OLD factor (and possibly an
                    # easier regime); the first post-refresh count is
                    # the fresh-H0 reference for the current regime,
                    # otherwise a run-global minimum makes the policy
                    # degenerate to per-frame rebuilds once the scene
                    # legitimately hardens (ADVICE r4).
                    self._it_base = None
                    self._base_from_frame = self.frame
                else:
                    self._fsr += 1
            # start the device->host copies NOW: device_get in _record
            # only begins a transfer when called, so without this the
            # pipelined download still pays its full latency inline
            # (the (STATS_CAP, 3) rows buffer is ~240 KB/frame)
            for leaf in jax.tree.leaves((stats, sys_e)):
                try:
                    leaf.copy_to_host_async()
                except (AttributeError, RuntimeError):
                    pass
            pending.append((self.frame, stats, sys_e, tol))
            self.frame += 1
            if self.viewer is not None:
                # live publish costs one synchronous x download per frame
                # (viewer mode trades pipelining for liveness)
                self.viewer.submit(
                    np.asarray(self.state.x)[self._surf_verts],
                    self.frame, float(sys_e))
            if len(pending) > pipeline:
                self._record(*pending.pop(0))
            self.timer.stop()
            if i == 0:
                jax.block_until_ready(self.state.x)
                t_warm = time.perf_counter()  # first frame pays the compile
        self.timer.start("save")
        while pending:
            self._record(*pending.pop(0))
        jax.block_until_ready(self.state.x)
        self.timer.stop()
        wall = time.perf_counter() - t_begin
        self.steady_spf = ((time.perf_counter() - t_warm) / (n - 1)
                           if n > 1 else wall)
        if not self.mute:
            print(f"ran {n} frames in {wall:.3f}s "
                  f"({wall / max(n, 1):.4f} s/frame, "
                  f"steady {self.steady_spf:.4f} s/frame)")
        return wall / max(n, 1)

    def _record(self, frame, stats, sys_e, tol):
        # one device->host transfer for all per-frame stats
        stats, sys_e = jax.device_get((stats, sys_e))
        it = int(stats.inner_iters)
        if self._h0_policy == -1 and frame >= 1:
            # adaptive H0 refresh: request a rebuild when the (lagged)
            # iteration count regresses past the baseline of the current
            # refresh epoch (frames since the last rebuild); frames that
            # ran on the pre-refresh factor are ignored for baselining
            if frame >= getattr(self, "_base_from_frame", 0):
                if self._it_base is None or it < self._it_base:
                    self._it_base = it
                elif it > self._it_base * 1.5 + 2:
                    self._refresh_req = True
        self.inner_iter_total += it
        self.ls_total += int(stats.ls_halvings)
        rows = np.asarray(stats.rows[:min(it + 1, rows_cap(stats))])
        for r in rows:
            self._iter_stats.write(
                f"{frame} {r[0]:.6g} {r[1]:.10e} {r[2]:.10e}\n")
        self._log.write(
            f"Timestep{frame} innerIterAmt = {self.inner_iter_total}, "
            f"accumulated line search steps {self.ls_total}\n")
        self._log.write(f"{frame}th tol: {tol:.6e}\n")
        self._log.write(f"sysE = {float(sys_e):.10e}\n")
        if bool(stats.stopped) and int(stats.inner_iters) == 0:
            self._log.write("\tline search with Armijo's rule failed!!!\n")
        self._log.flush()
        self._iter_stats.flush()

    # ------------------------------------------------------------------
    def save_status(self):
        x = np.asarray(self.state.x, np.float64)
        v = np.asarray(self.state.v, np.float64).reshape(-1)
        dxe = np.asarray(self.state.dx_elastic, np.float64)
        n = self.frame
        with open(os.path.join(self.out, f"status{n}"), "w") as f:
            f.write(f"timestep {n}\n")
            f.write(f"\nposition {x.shape[0]} 3\n")
            for r in x:
                f.write("%le %le %le\n" % (r[0], r[1], r[2]))
            f.write(f"\nvelocity {v.size}\n")
            for val in v:
                f.write("%le\n" % val)
            f.write(f"\ndx_Elastic {dxe.shape[0]} 3\n")
            for r in dxe:
                f.write("%le %le %le\n" % (r[0], r[1], r[2]))
        meshio.write_obj(os.path.join(self.out, f"{n}.obj"),
                         x[self._surf_verts], self._surf_faces)

    def _load_status(self, path):
        """Resume (reference: Optimizer ctor, Optimizer.cpp:126-177)."""
        x, v, dxe, frame = parse_status(path)
        # Per-stepper state reconstruction: each stepper knows how (or
        # whether) to refresh its own factors at the restored positions.
        self.state = self.stepper.restore(x, v, dxe)
        self.frame = frame

    # ------------------------------------------------------------------
    def finalize(self):
        self.save_status()
        x = np.asarray(self.state.x, np.float64)
        meshio.save_tet_mesh(os.path.join(self.out, "finalResult_mesh.msh"),
                             x, self.mesh.conn, self.mesh.SF)
        if self.render:
            # per-run visual outputs 0.png / finalResult.png / anim.gif
            # over the saved surface objs (reference: viewer capture loop
            # main.cpp:955-978, still captures main.cpp:318-358)
            from .render import render_run_dir
            self.timer.start("render")
            try:
                render_run_dir(self.out, fps=max(1, round(1.0 / self.cfg.dt)))
            except Exception as exc:  # rendering is best-effort
                if not self.mute:
                    print(f"(render skipped: {exc})")
            self.timer.stop()
        with open(os.path.join(self.out, "info.txt"), "w") as f:
            f.write(f"vertAmt {self.mesh.n_vert}\n"
                    f"elemAmt {self.mesh.n_elem}\n")
            f.write(f"frames {self.frame}\n")
            f.write(f"innerIterTotal {self.inner_iter_total}\n")
            f.write(f"lineSearchTotal {self.ls_total}\n")
            f.write("--- timing (s) ---\n")
            f.write(self.timer.report() + "\n")
            if self.profile:
                # per-activity attribution in the reference's info.txt
                # vocabulary (main.cpp:864-888), measured on isolated
                # jitted stage programs at the final state
                from .profiling import profile_step_components, \
                    format_activities
                try:
                    acts = profile_step_components(self.stepper, self.state)
                    f.write(format_activities(acts) + "\n")
                except Exception as exc:  # profiling is best-effort
                    f.write(f"(stage profiling unavailable: {exc})\n")
        self._iter_stats.close()
        self._log.close()


def parse_status(path):
    """Parse a plain-text status<n> checkpoint into (x, v, dx_elastic,
    frame) — same token format as the reference (Optimizer.cpp:126-177)."""
    with open(path) as f:
        toks = f.read().split()
    i = 0
    x = v = dxe = None
    frame = 0
    while i < len(toks):
        t = toks[i]
        if t == "timestep":
            frame = int(toks[i + 1]); i += 2
        elif t == "position":
            r, c = int(toks[i + 1]), int(toks[i + 2])
            x = np.asarray(toks[i + 3: i + 3 + r * c],
                           np.float64).reshape(r, c)
            i += 3 + r * c
        elif t == "velocity":
            nvals = int(toks[i + 1])
            v = np.asarray(toks[i + 2: i + 2 + nvals],
                           np.float64).reshape(-1, 3)
            i += 2 + nvals
        elif t == "dx_Elastic":
            r, c = int(toks[i + 1]), int(toks[i + 2])
            dxe = np.asarray(toks[i + 3: i + 3 + r * c],
                             np.float64).reshape(r, c)
            i += 3 + r * c
        else:
            i += 1
    return x, v, dxe, frame


def rows_cap(stats):
    return stats.rows.shape[0]


def run_script(script_path, suffix="", frames=None, output_root="output",
               dtype=None, save_every=1, profile=False, viewer=False):
    cfg = Config.load(script_path)
    name = cfg.output_folder_name()
    if suffix:
        name += "_" + suffix
    out = os.path.join(output_root, name)
    sim = Simulator(cfg, out, dtype=pick_dtype(dtype), save_every=save_every,
                    profile=profile, viewer=viewer,
                    search_dirs=(os.path.dirname(script_path),
                                 os.path.dirname(os.path.dirname(script_path))))
    sec_per_frame = sim.run(frames)
    sim.finalize()
    if sim.viewer is not None:
        sim.viewer.finish()
    return sim, sec_per_frame
