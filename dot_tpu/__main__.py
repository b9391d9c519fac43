"""CLI entry: `python -m dot_tpu <mode> <script.txt> [suffix]`

Mirrors the reference binary's interface (reference: main.cpp:599-664):
  mode 0/10/100 : simulate the scene script (all offline/headless here)
  mode 1        : diagnostics (11 = derivative unit tests, via pytest files)
  mode 2        : mesh processing utilities

Extra flags (ours): --frames N, --dtype {f32,f64}, --save-every K.
"""

from __future__ import annotations

import argparse
import sys

from .device import device_line


def main(argv=None):
    """Run the CLI; simulation modes return the finished simulator."""
    ap = argparse.ArgumentParser(prog="dot_tpu")
    ap.add_argument("mode", help="0/10/100 sim, 1 diagnostic, 2 mesh proc")
    ap.add_argument("script", nargs="?", help="scene script .txt / sub-mode")
    ap.add_argument("suffix", nargs="?", default="", help="output folder tag")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--dtype", choices=["f32", "f64"], default=None)
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--output-root", default="output")
    ap.add_argument("--status", default=None,
                    help="status file for mode 2 status2obj")
    ap.add_argument("--profile", action="store_true",
                    help="append per-activity stage timings to info.txt")
    ap.add_argument("--no-viewer", action="store_true",
                    help="mode 0: run without the interactive HTTP viewer")
    args = ap.parse_args(argv)

    if args.mode in ("0", "10", "11", "100"):
        print(f"device: {device_line()}", flush=True)
        from .config import Config
        from .dim2 import is_2d_shape
        if is_2d_shape(Config.load(args.script).shape):
            # 2D primitive scene (DIM=2 pipeline; reference:
            # Mesh.cpp:110-435 + the dim==2 template instantiation)
            from .dim2 import run_script_2d
            sim, spf = run_script_2d(args.script, suffix=args.suffix,
                                     frames=args.frames, dtype=args.dtype,
                                     output_root=args.output_root,
                                     save_every=args.save_every)
            print(f"done: {sim.frame}/{sim.frame_amt} 2D frames, "
                  f"{spf:.4f} s/frame")
            print(f"output: {sim.out}")
            return sim
        from .sim import run_script
        # mode 0 = interactive (the reference's viewer window, main.cpp
        # mode 0); modes 10/100 stay headless/offline
        live = args.mode == "0" and not args.no_viewer
        sim, spf = run_script(args.script, suffix=args.suffix,
                              frames=args.frames, dtype=args.dtype,
                              output_root=args.output_root,
                              save_every=args.save_every,
                              profile=args.profile, viewer=live)
        steady = getattr(sim, "steady_spf", spf)
        print(f"done: {sim.frame}/{sim.frame_amt} frames, {spf:.4f} s/frame, "
              f"steady {steady:.4f} s/frame")
        print(f"output: {sim.out}")
        if sim.viewer is not None:
            print(f"viewer still serving at {sim.viewer.url} — Ctrl-C to exit")
            sim.viewer.serve_forever()
        return sim
    elif args.mode == "1":
        if args.script == "13":
            # diagMode 13: extract sysE rows from a log.txt into sysE.txt
            # next to it (reference: Diagnostic.hpp:75-106)
            import os
            import re
            log_path = args.suffix
            if not log_path:
                print("please input log file path")
                sys.exit(1)
            vals = []
            with open(log_path) as f:
                for line in f:
                    m = re.match(r"sysE = (\S+)", line)
                    if m:
                        vals.append(float(m.group(1)))
            out = os.path.join(os.path.dirname(log_path), "sysE.txt")
            with open(out, "w") as f:
                for v in vals:
                    f.write("%le\n" % v)
            print(f"wrote {out} ({len(vals)} rows)")
        else:
            # diagMode 11: derivative unit tests (reference Diagnostic 11)
            import pytest
            sys.exit(pytest.main(["-q", "tests/test_materials.py",
                                  "tests/test_svd3.py"]))
    elif args.mode == "2":
        from . import io as meshio
        sub = args.script
        if sub == "surface":
            # extract surface tris: mode 2 case 15 (MeshProcessing.hpp:604)
            import os
            v, tt, sf = meshio.read_tet_mesh(args.suffix)
            out = os.path.basename(args.suffix) + ".obj"  # write to cwd,
            # never next to the (possibly read-only) input mesh
            meshio.write_obj(out, v, sf)
            print(f"wrote {out}")
        elif sub == "status2obj":
            # status file -> surface obj (mode 2 case 16,
            # MeshProcessing.hpp:679-780); usage:
            #   python -m dot_tpu 2 status2obj <mesh.msh> --status <status>
            import os
            import numpy as np
            v, tt, sf = meshio.read_tet_mesh(args.suffix)
            from .sim import parse_status
            x, _, _, frame = parse_status(args.status)
            surf = np.unique(sf.ravel())
            remap = np.full(v.shape[0], -1, np.int64)
            remap[surf] = np.arange(len(surf))
            out = os.path.basename(args.status) + ".obj"
            meshio.write_obj(out, x[surf], remap[sf])
            print(f"wrote {out} (frame {frame})")
        elif sub in ("bench-energy", "bench-svd"):
            # kernel microbenches: mode 2 cases 10/11/12
            # (MeshProcessing.hpp:274,317,376 — energy-eval and batched-SVD
            # profiling on a loaded tet mesh)
            import time
            import jax
            import jax.numpy as jnp
            from .config import Config
            from .mesh import Mesh
            from .steppers.core import System
            cfg = Config(energy="FCR", dt=0.025)
            cfg.shape = "input"
            cfg.input_shape_path = args.suffix
            mesh = Mesh.from_config(cfg)
            system = System(mesh, cfg, None)
            x = jnp.asarray(mesh.V_rest, system.dtype)
            if sub == "bench-svd":
                fn = jax.jit(lambda sy, x: sy.fsvd(x)[2])
            else:
                fn = jax.jit(lambda sy, x: sy.energy_at(
                    x, jnp.zeros_like(x))[0])
            jax.device_get(fn(system, x))  # compile
            reps = 50
            t0 = time.perf_counter()
            for _ in range(reps):
                r = fn(system, x)
            jax.device_get(r)
            dt_ = (time.perf_counter() - t0) / reps
            print(f"{sub} on {device_line()}: {mesh.n_elem} elements, "
                  f"{dt_ * 1e3:.3f} ms/eval "
                  f"({mesh.n_elem / dt_ / 1e6:.1f} M elem/s)")
        elif sub == "gen2d":
            # 2D primitive generation (reference: Mesh.cpp:110-435 DIM==2
            # ctor; Triangle-quality meshing of grid/square/rectangle/
            # cylinder/spikes/sharkey) — writes a z=0 triangle OBJ plus a
            # .handles file with the two border-vertex chains
            import os
            from . import mesh_gen as mg
            gens = {"grid": mg.grid_2d, "square": mg.square_2d,
                    "rectangle": mg.rectangle_2d, "cylinder": mg.cylinder_2d,
                    "spikes": mg.spikes_2d, "sharkey": mg.sharkey_2d}
            name = args.suffix or "grid"
            if name not in gens:
                print(f"gen2d primitives: {', '.join(sorted(gens))}")
                sys.exit(1)
            V, F, bv = gens[name](1.0, args.frames or 1000)
            out = f"{name}2d.obj"
            meshio.write_obj(out, V, F)
            with open(f"{name}2d.handles", "w") as f:
                for chain in bv:
                    f.write(" ".join(str(int(i)) for i in chain) + "\n")
            print(f"wrote {out} ({len(V)} verts, {len(F)} tris) + "
                  f"{name}2d.handles")
        elif sub == "invert-normals":
            # mode 2 case 0 (MeshProcessing.hpp:95-104): swap winding
            import os
            V, F = meshio.read_obj(args.suffix)
            F[:, 1], F[:, 2] = F[:, 2].copy(), F[:, 1].copy()
            out = os.path.basename(args.suffix).rsplit(".", 1)[0] \
                + "_processed.obj"
            meshio.write_obj(out, V, F)
            print(f"wrote {out}")
        elif sub == "obj2cpp":
            # mode 2 case 5 (MeshProcessing.hpp:248-273): dump an OBJ's
            # V/F as comma-separated literals (one line each)
            import os
            V, F = meshio.read_obj(args.suffix)
            out = os.path.basename(args.suffix).rsplit(".", 1)[0] + ".txt"
            with open(out, "w") as f:
                f.write(", ".join("%le" % c for v in V for c in v) + "\n")
                f.write(", ".join("%d" % c for t in F for c in t) + "\n")
            print(f"wrote {out}")
        elif sub == "tetrahedralize":
            # surface OBJ -> tet mesh (mode 2 case 3,
            # MeshProcessing.hpp:106-186; TetGen's role is played by the
            # from-scratch lattice stuffer in mesh_gen.tet_from_surface)
            import os
            from .mesh_gen import tet_from_surface
            V, F = meshio.read_obj(args.suffix)
            m = tet_from_surface(V, F, elem_amt=args.frames or 10000)
            out = os.path.basename(args.suffix) + ".msh"
            meshio.save_tet_mesh(out, m.V_rest, m.conn, m.SF)
            print(f"wrote {out} ({m.n_vert} verts, {m.n_elem} tets)")
        elif sub == "inspect":
            # mode 2 case 4 (MeshProcessing.hpp:187-247): check a tet
            # mesh for inverted elements (det of the edge matrix <= 0)
            # and report basic stats; the libigl viewer clip-plane view
            # becomes an optional slice OBJ of the lower-z half's tets.
            import os
            import numpy as np
            v, tt, sf = meshio.read_tet_mesh(args.suffix)
            e = v[tt[:, 1:]] - v[tt[:, :1]]          # (n, 3, 3) edge rows
            det = np.linalg.det(np.swapaxes(e, 1, 2))
            bad = np.flatnonzero(det <= 0.0)
            for i in bad:
                print(f"element inversion detected {det[i]:.6e} (tet {i})")
            if bad.size == 0:
                print("no element inversion")
            print(f"{v.shape[0]} verts, {tt.shape[0]} tets, "
                  f"{sf.shape[0]} surface tris, "
                  f"vol [{det.min() / 6:.3e}, {det.max() / 6:.3e}]")
            if args.status:  # optional: write the clip-view OBJ here
                bc = v[tt].mean(axis=1)[:, 2]
                t = bc - bc.min()
                keep = np.flatnonzero(t < (t.max() or 1.0) * (5.0 / 9.0))
                quadf = np.array([[0, 1, 3], [0, 2, 1], [3, 2, 0],
                                  [1, 2, 3]])
                Vt = v[tt[keep]].reshape(-1, 3)
                Ft = (quadf[None] + 4 * np.arange(len(keep))[:, None, None]
                      ).reshape(-1, 3)
                meshio.write_obj(args.status, Vt, Ft)
                print(f"wrote clip view {args.status}")
        elif sub == "couttest":
            # mode 2 case 13 (MeshProcessing.hpp:578-598): time stdout
            # writes vs a disabled stream — ported as a sanity check of
            # the mute path the Simulator uses for benchmarking
            import io
            import time
            n = args.frames or 100000
            t0 = time.perf_counter()
            for i in range(n):
                print("something simething ssser ilninive", i)
            t1 = time.perf_counter()
            sink = io.StringIO()
            for i in range(n):
                print("something simething ssser ilninive", i, file=sink)
            t2 = time.perf_counter()
            print(f"cout: {t1 - t0:.3f}s  disabled: {t2 - t1:.3f}s "
                  f"({(t1 - t0) / max(t2 - t1, 1e-9):.1f}x)")
        elif sub == "render":
            # render a run directory's saved frames to anim.gif (+PNGs) —
            # the offline viewer-capture role (main.cpp:955-978, GIF.hpp)
            from .render import render_run_dir
            gif = render_run_dir(args.suffix, png_every=10)
            print(f"wrote {gif}")
        elif sub == "screenshot":
            # single surface obj -> PNG
            import os
            from . import render
            V, F = meshio.read_obj(args.suffix)
            imgs, pal = render.render_frames([(V, F)])
            out = os.path.basename(args.suffix) + ".png"
            render.write_png(out, imgs[0], pal)
            print(f"wrote {out}")
        else:
            print("mesh-processing sub-modes: surface <path.msh>, "
                  "status2obj <path.msh> --status <statusN>, "
                  "inspect <path.msh> [--status clip.obj], "
                  "render <run_dir>, screenshot <surface.obj>, "
                  "gen2d <grid|square|rectangle|cylinder|spikes|sharkey> "
                  "[--frames elemAmt], tetrahedralize <surface.obj> "
                  "[--frames elemAmt], couttest [--frames N]")
    else:
        print(f"unknown mode {args.mode}")
        sys.exit(1)


if __name__ == "__main__":
    main()
