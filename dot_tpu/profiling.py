"""Per-activity timing attribution (reference: the 14-activity
`timer_step` dump in main.cpp:864-888, printed to info.txt:338-358).

The reference interleaves host timers with solver stages. Here the whole
inner solve is one jitted XLA program, so stages cannot be timed in situ;
instead each stage's jitted sub-program is re-run on the final simulation
state and timed in isolation. The numbers are representative per-CALL
device times (the jitted step fuses stages, so the in-step cost is a
lower bound of the sum), but they are reproducible and use the same
activity vocabulary as the reference's info.txt.
"""

from __future__ import annotations

import time

import jax


def _time_call(fn, *args, reps=3):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def profile_step_components(stepper, state, reps=3):
    """Times the solver-stage sub-programs on `state` and returns
    {reference-activity-name: seconds-per-call}. Works for any stepper
    built on the shared System; stages a stepper doesn't use are omitted."""
    sys = stepper.system
    x, x_tilta, fixed = state.x, state.x_tilta, state.fixed
    acts = {}

    # the System rides through every stage jit as a pytree ARGUMENT (see
    # core.StaticPytree) — no plan constants in the stage programs
    fsvd = jax.jit(lambda sy, x: sy.fsvd(x))
    F, U, s, V = fsvd(sys, x)
    acts["lineSearch_eVal"] = _time_call(
        jax.jit(lambda sy, x: sy.energy(x, x_tilta, sy.fsvd(x)[2])),
        sys, x, reps=reps)
    grad = jax.jit(lambda sy, x: sy.gradient(x, x_tilta, fixed,
                                             *sy.fsvd(x)))
    acts["compGrad"] = _time_call(grad, sys, x, reps=reps)

    if getattr(sys, "plan", None) is not None:
        eh = jax.jit(lambda sy, U, s, V: sy.element_hessians(U, s, V))
        elem_h = eh(sys, U, s, V)
        acts["matrixComputation"] = _time_call(eh, sys, U, s, V, reps=reps)
        asm = jax.jit(lambda sy, h: sy.assemble_subdomains(h, fixed))
        Hd = asm(sys, elem_h)
        acts["matrixAssembly"] = _time_call(asm, sys, elem_h, reps=reps)
        # time what the step really runs: quasi-Newton H0 rebuilds use
        # the fast (bf16-SYRK / tiered) factorization, not the exact one
        fac = jax.jit(lambda sy, Hd: sy.factorize_fast(Hd))
        L, d = fac(sys, Hd)
        acts["numericalFactorization"] = _time_call(fac, sys, Hd, reps=reps)
        if hasattr(state, "chol"):
            # pass the (large) factors as ARGUMENTS — closed over, they
            # would be baked into the program as constants
            solve = jax.jit(lambda sy, chol, equil, q:
                            sy.h0_apply(chol, equil, q))
            g = grad(sys, x)
            acts["backSolve"] = _time_call(solve, sys, state.chol,
                                           state.equil, -g, reps=reps)
            acts["modifySearchDir"] = _time_call(
                jax.jit(lambda sy, eh, p: sy.quadratic_form(eh, p)),
                sys, state.elem_h,
                solve(sys, state.chol, state.equil, -g), reps=reps)
    return acts


def format_activities(acts):
    """info.txt block in the reference's `N activities:` shape
    (main.cpp:864-888)."""
    lines = [f"{len(acts)} activities (s/call, isolated jitted stages):"]
    for k, v in sorted(acts.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {v:10.6f} s: {k}")
    return "\n".join(lines)
