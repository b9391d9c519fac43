"""Collect per-scene results from run directories into a markdown table
(the tb1-tb5 / otherMethods evaluation summary).

    python tools/results_table.py output/dirA output/dirB ... > results.md

Each run directory must contain config.txt, iterStats.txt, log.txt and
(after finalize) info.txt. sec/frame is taken from the `sec_per_frame`
line info.txt gets from the driver when present, else from the `step`
timer bucket divided by frames.
"""

from __future__ import annotations

import os
import re
import sys


def scan(run_dir):
    cfg = {}
    for line in open(os.path.join(run_dir, "config.txt")):
        t = line.split()
        if t:
            cfg[t[0]] = " ".join(t[1:])
    frames = set()
    iters = 0
    for line in open(os.path.join(run_dir, "iterStats.txt")):
        t = line.split()
        if len(t) >= 4:
            frames.add(int(t[0]))
            iters += 1
    n_frames = len(frames)
    iters -= n_frames  # row 0 of each frame is the pre-iteration state
    sys_e = None
    ls_total = 0
    for line in open(os.path.join(run_dir, "log.txt")):
        m = re.match(r"sysE = (\S+)", line)
        if m:
            sys_e = float(m.group(1))
        m = re.search(r"accumulated line search steps (\d+)", line)
        if m:
            ls_total = int(m.group(1))
    spf = None
    info = os.path.join(run_dir, "info.txt")
    if os.path.exists(info):
        txt = open(info).read()
        m = re.search(r"^step (\S+)", txt, re.M)
        if m and n_frames:
            spf = float(m.group(1)) / n_frames
    return {
        "scene": os.path.basename(run_dir.rstrip("/")),
        "stepper": cfg.get("timeStepper", "?"),
        "energy": cfg.get("energy", "?"),
        "frames": n_frames,
        "spf": spf,
        "iters_pf": iters / max(n_frames, 1),
        "ls_total": ls_total,
        "sysE": sys_e,
    }


def main(dirs):
    rows = [scan(d) for d in dirs]
    print("| scene | stepper | frames | sec/frame | iters/frame | "
          "line-search halvings | final sysE |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        spf = f"{r['spf']:.3f}" if r["spf"] else "—"
        print(f"| {r['scene']} | {r['stepper']} | {r['frames']} | {spf} | "
              f"{r['iters_pf']:.1f} | {r['ls_total']} | "
              f"{r['sysE']:.6e} |" if r["sysE"] is not None else
              f"| {r['scene']} | {r['stepper']} | {r['frames']} | {spf} | "
              f"{r['iters_pf']:.1f} | {r['ls_total']} | — |")


if __name__ == "__main__":
    main(sys.argv[1:])
