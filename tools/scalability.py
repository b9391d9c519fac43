"""Scalability sweep on generated structured bars (tb1 protocol).

The reference's tb1 horse sweep (input/tb1_horse_scalab/) scales one
shape through 7K -> 136K vertices; those larger meshes are not shipped
in the reference repo, so matched-size structured bars stand in
(dot_tpu.scenes.BARS). For each size this tool generates the bar once
(under output/scalab/meshes), writes a twist scene script, runs it
through the production Simulator (DOT blockSize 1024 by default, same
partitioning path as real scenes), and prints one JSON line with the
steady sec/frame and the device it ran on.

    python tools/scalability.py bar17 bar35 bar69 bar135 bar265 \
        [--stepper "DOT -1 1024"] [--frames 8] [--warmup 2]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def run_one(name, stepper, frames, warmup, root, extra=""):
    import jax
    from dot_tpu.sim import Simulator, pick_dtype
    from dot_tpu.config import Config
    from dot_tpu.scenes import write_bar_scene

    tag = (stepper + extra).replace(" ", "_").replace("\n", "_")
    scene = write_bar_scene(root, name, stepper=stepper,
                            extra=[extra] if extra else (),
                            name=f"{name}_{tag}")

    cfg = Config.load(scene)
    out = os.path.join(root, f"run_{name}_{tag}")
    t_build = time.perf_counter()
    sim = Simulator(cfg, out, dtype=pick_dtype(), save_every=10 ** 9, render=False,
                    mute=True)
    build_s = time.perf_counter() - t_build
    sim.run(warmup)
    it0, f0 = sim.inner_iter_total, sim.frame
    t0 = time.perf_counter()
    sim.run(frames)
    n = max(sim.frame - f0, 1)
    spf = (time.perf_counter() - t0) / n
    iters = (sim.inner_iter_total - it0) / n
    sim.finalize()
    return {"scene": name, "stepper": stepper, "extra": extra,
            "tets": int(sim.mesh.n_elem), "verts": int(sim.mesh.n_vert),
            "sec_per_frame": round(spf, 4),
            "iters_per_frame": round(iters, 2),
            "build_s": round(build_s, 1),
            "device": f"{jax.devices()[0].platform} "
                      f"{jax.devices()[0].device_kind}"}


def main(argv=None):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from dot_tpu.scenes import BARS

    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="+", choices=sorted(BARS))
    ap.add_argument("--stepper", default="DOT -1 1024")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--root", default="output/scalab")
    ap.add_argument("--extra", default="",
                    help="extra scene-script line(s), e.g. 'applyDtype f32'")
    args = ap.parse_args(argv)

    os.makedirs(args.root, exist_ok=True)
    for name in args.names:
        try:
            res = run_one(name, args.stepper, args.frames, args.warmup,
                          args.root, extra=args.extra)
        except Exception as e:
            res = {"scene": name, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
