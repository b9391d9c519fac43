#!/usr/bin/env python
"""Headline benchmark: sec/frame on the bar17K-class twist bar at the
reference's canonical DOT configuration (FCR, BE, DOT 6 subdomains,
warmStart 2, dt = 0.025, E = 1e5, nu = 0.4, rho = 1000 — the settings of
input/bar17K_twist_DOT.txt), characteristic-gradient tolerance
relTol = 1e-5. The bar is generated (dot_tpu.scenes, 56x16x16 cells:
86K tets, 16.5K verts); DOT_BENCH_SCRIPT names another scene script.

Runs on a GPU only: on any other device it exits without a result.
Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "...", "vs_baseline": N,
   "device": {"platform", "kind", "count", "name_power_limit"}, ...}

`value` / `vs_baseline` are measured at STRICT reference semantics
(h0Refresh 1: the frozen preconditioner is refactorized every time step,
exactly like DOTTimeStepper.cpp:343). The same JSON also reports
`value_adaptive_h0` / `vs_baseline_adaptive_h0`: the dot_tpu extension
(h0Refresh -1) that extends the factor's lifetime across frames until
the lagged iteration count regresses — tolerance untouched, staleness
can only cost iterations (guarded by
test_stale_h0_still_converges_to_same_physics). Set DOT_BENCH_H0REFRESH
to pin a single policy and skip the second measurement.

Baseline: the reference repo publishes no numbers (BASELINE.md). Two
ratios are reported against the MEASURED reference-binary run in
BASELINE_CPU.json (9.349 s/frame for 200-frame bar17K_twist DOT6, built
and run from the reference sources on 1 CPU core with netlib BLAS):

- `vs_baseline_1core_measured`: against that number as is;
- `vs_baseline_12thread_est`: that number divided by 6 (the conservative
  end of the 4-8x range a 6C/12T MKL machine gains over the 1-core
  netlib build; see baselines/README.md). `vs_baseline` carries this.

The baseline ran the reference's own bar17K mesh (17.3K verts), not the
generated bar, so both ratios are approximate (`vs_baseline_exact_scene`
is false) unless DOT_BENCH_SCRIPT names the reference scene.
"""

import json
import os
import sys
import time

PLACEHOLDER_CPU_SPF = 1.0  # s/frame; see module docstring


def _run(script, h0_refresh, warmup, frames):
    from dot_tpu.sim import Simulator, pick_dtype
    from dot_tpu.config import Config
    cfg = Config.load(script)
    cfg.h0_refresh = h0_refresh
    out = os.path.join("output", "bench_" + cfg.output_folder_name())
    sim = Simulator(cfg, out, dtype=pick_dtype(), save_every=10 ** 9,
                    mute=True, render=False)
    sim.run(warmup)  # compile + settle
    t0 = time.perf_counter()
    sim.run(frames)
    spf = (time.perf_counter() - t0) / frames
    sim.finalize()
    return spf


def main():
    from dot_tpu import device
    dev = device.require_gpu("bench.py")
    dev["name_power_limit"] = device.card_name_and_power_limit()

    script = os.environ.get("DOT_BENCH_SCRIPT")
    if script is None:
        from dot_tpu.scenes import write_bar_scene
        script = write_bar_scene(os.path.join("output", "bench"), "bar17",
                                 stepper="DOT 6")
    warmup = int(os.environ.get("DOT_BENCH_WARMUP", "3"))
    frames = int(os.environ.get("DOT_BENCH_FRAMES", "10"))

    pinned = os.environ.get("DOT_BENCH_H0REFRESH")
    spf = _run(script, 1 if pinned is None else int(pinned), warmup, frames)
    spf_adaptive = None
    if pinned is None:
        spf_adaptive = _run(script, -1, warmup, frames)

    baseline = PLACEHOLDER_CPU_SPF
    here = os.path.dirname(os.path.abspath(__file__))
    cpu_json = os.path.join(here, "BASELINE_CPU.json")
    if os.path.exists(cpu_json):
        with open(cpu_json) as f:
            baseline = json.load(f).get("bar17K_twist_DOT6_sec_per_frame",
                                        baseline)

    # The measured baseline binary ran on 1 core with netlib BLAS; the
    # paper's machine was 6C/12T MKL. Divide by 6 (conservative end of
    # the observed 4-8x multithread/MKL gain) for the headline ratio.
    MT_SCALE = 6.0
    rec = {
        "metric": "sec_per_frame_bar17K_twist_DOT6",
        "value": round(spf, 5),
        "unit": "s/frame",
        "vs_baseline": round(baseline / MT_SCALE / spf, 3),
        "vs_baseline_1core_measured": round(baseline / spf, 3),
        "vs_baseline_12thread_est": round(baseline / MT_SCALE / spf, 3),
        "vs_baseline_exact_scene": os.path.basename(script)
        == "bar17K_twist_DOT.txt",
        "h0_refresh": 1 if pinned is None else int(pinned),
        "device": dev,
    }
    if spf_adaptive is not None:
        rec["value_adaptive_h0"] = round(spf_adaptive, 5)
        rec["vs_baseline_adaptive_h0"] = round(
            baseline / MT_SCALE / spf_adaptive, 3)
    print(json.dumps(rec))


if __name__ == "__main__":
    sys.exit(main())
