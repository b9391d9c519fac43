"""Multi-chip sharding layer: device-mesh placement rules for the
framework's model-parallel axis (the subdomain axis `sbd`).

Design (replaces the reference's TBB shared-memory element
parallelism, Energy.cpp:309-324, and its per-subdomain thread pools):

- Elements are reordered SUBDOMAIN-CONTIGUOUS with equal padding per
  part (partition.build_plan: nEp = P * elem_pad), so sharding the
  element axis into P equal chunks aligns exactly with subdomain
  boundaries. The per-element chain (deformation gradients, flip-SVD,
  Psi/gradient/Hessian evaluation — the per-iteration cost floor)
  then partitions across devices with zero resharding.
- Subdomain-batched solver state (Cholesky factors, equilibration
  diagonals, local index images) shards on its P axis.
- Vertex-sized global fields (positions, velocities, masses) stay
  replicated; the vertex scatter-reduce of per-element gradients is
  XLA's collective to insert (an all-reduce over the device
  interconnect — NVLink on a 4-H100 host, which links every pair of
  cards, so a flat 1-D mesh is the right shape).

Because System/steppers are keyed pytrees (core.StaticPytree), the
placement rules are written against ATTRIBUTE NAMES and apply to any
stepper that carries a System.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# System attributes whose leading axis is the (padded, subdomain-
# contiguous) element axis nEp
ELEM_ATTRS = frozenset({
    "conn_g", "conn_s", "conn_cols", "vol_w", "u_e", "lam_e",
    "g9", "D_soa", "w_e",
    # ADMM-DD stepper attrs on the padded local element axis (the local
    # F/SVD/psi chain — the per-ADMM-iteration cost floor — partitions
    # with them)
    "conn_local",
})
# attributes whose leading axis is the subdomain axis P
PART_ATTRS = frozenset({
    "l2g", "local_valid", "mass_img", "mass_local", "is_dual",
    "l2shared", "mass_dif",
})


def device_mesh(n_devices, axis="sbd"):
    return Mesh(np.array(jax.devices()[:n_devices]), (axis,))


def _attr_name(path):
    name = None
    for e in path:
        if isinstance(e, jax.tree_util.GetAttrKey):
            name = e.name
    return name


def _system_spec(path, leaf, mesh, axis):
    name = _attr_name(path)
    n = mesh.shape[axis]
    shp = getattr(leaf, "shape", ())
    if (name in ELEM_ATTRS or name in PART_ATTRS) \
            and len(shp) >= 1 and shp[0] % n == 0 and shp[0] >= n:
        return NamedSharding(mesh, P(axis, *([None] * (len(shp) - 1))))
    return NamedSharding(mesh, P())


def shard_system_tree(tree, mesh, axis="sbd"):
    """device_put a System (or a stepper carrying one) with the sbd
    placement: the element axis and the subdomain axis map to `axis`;
    everything else replicates. Placement happens leaf-by-leaf (a
    shardings *tree* of a StaticPytree would not flatten — its leaves
    are not arrays)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jax.device_put(
            leaf, _system_spec(path, leaf, mesh, axis)), tree)


def dot_state_shardings(state, mesh, axis="sbd"):
    """Shardings for a quasi-Newton SimState: element-Hessian slabs on
    the element axis, factors/equilibration on the subdomain axis,
    global vertex fields replicated. Handles both the dense (P, n3, n3)
    factor and the scan-major BTDFactor layout."""
    from .steppers.core import BTDFactor

    rep = NamedSharding(mesh, P())
    n = mesh.shape[axis]

    def chol_spec(leaf):
        if isinstance(state.chol, BTDFactor):
            ok = leaf.ndim >= 2 and leaf.shape[1] % n == 0
            return NamedSharding(mesh, P(None, axis)) if ok else rep
        ok = leaf.ndim >= 1 and leaf.shape[0] % n == 0
        return NamedSharding(mesh, P(axis)) if ok else rep

    def eq_spec(leaf):
        ok = leaf.ndim >= 1 and leaf.shape[0] % n == 0
        return NamedSharding(mesh, P(axis)) if ok else rep

    def eh_spec(leaf):
        ok = leaf.ndim >= 2 and leaf.shape[1] % n == 0
        return NamedSharding(mesh, P(None, axis)) if ok else rep

    return state._replace(
        **{f: rep for f in ("x", "x_n", "v", "x_tilta", "dx_elastic",
                            "fixed", "vel_sign", "released",
                            "lb_s", "lb_t", "lb_rho", "lb_valid")},
        elem_h=eh_spec(state.elem_h),
        chol=jax.tree.map(chol_spec, state.chol),
        equil=jax.tree.map(eq_spec, state.equil),
        # the (6P, 6P) two-level coarse factor is tiny — replicate it so
        # the coarse solve is local on every device (None stays None)
        kc_chol=jax.tree.map(lambda _leaf: rep, state.kc_chol),
    )


def admm_dd_state_shardings(state, mesh, axis="sbd"):
    """Shardings for an ADMMDDState: the element-Hessian slab shards on
    its (trailing) element axis; the compact interface-weight values and
    the consensus factor replicate (the consensus solve is the global
    coupling step — it is the part that MUST see all subdomains, the
    reference's boundaryConsensusSolve, ADMMDDTimeStepper.cpp:1254-1344);
    global vertex fields replicate."""
    rep = NamedSharding(mesh, P())
    n = mesh.shape[axis]
    eh = state.elem_h
    eh_ok = eh.ndim >= 2 and eh.shape[1] % n == 0
    return state._replace(
        **{f: rep for f in ("x", "x_n", "v", "x_tilta", "dx_elastic",
                            "fixed", "vel_sign", "released",
                            "w_vals", "cons_chol", "cons_equil")},
        elem_h=NamedSharding(mesh, P(None, axis)) if eh_ok else rep,
    )


def replicated_state_shardings(state, mesh, axis="sbd"):
    """All-replicated state placement: used for ADMM-PD (whose only
    model-parallel axis is the element axis of the System statics — the
    local sigma-space Newton is elementwise; the global solve is one
    whole-mesh factor) and for GSDD (whose Gauss-Seidel sweep visits one
    subdomain at a time via dynamic slicing — sharding the factor stack
    would turn every sweep iteration into an all-gather)."""
    rep = NamedSharding(mesh, P())
    return jax.tree.map(lambda _: rep, state)


def state_shardings(state, mesh, axis="sbd", stepper=None):
    """Placement rules for any stepper family's state pytree."""
    from .steppers.core import SimState
    from .steppers.admm_dd import ADMMDDState

    if isinstance(state, ADMMDDState):
        return admm_dd_state_shardings(state, mesh, axis)
    if isinstance(state, SimState):
        if stepper is not None and getattr(stepper, "name", "") == "GSDD":
            return replicated_state_shardings(state, mesh, axis)
        return dot_state_shardings(state, mesh, axis)
    return replicated_state_shardings(state, mesh, axis)


def shard_for_step(stepper, state, mesh, axis="sbd"):
    """device_put the (stepper, state) pair with the sbd placement; the
    jitted step then runs SPMD with XLA-inserted collectives."""
    st_sh = shard_system_tree(stepper, mesh, axis)
    state_sh = jax.device_put(
        state, state_shardings(state, mesh, axis, stepper=stepper))
    return st_sh, state_sh


# ---------------------------------------------------------------------------
# collective-traffic accounting (what moves between devices per step
# program)
# ---------------------------------------------------------------------------
_COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                   "collective-permute", "all-to-all")

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "u64": 8,
                "s64": 8, "u32": 4, "s32": 4, "u16": 2, "s16": 2,
                "u8": 1, "s8": 1, "pred": 1}


def collective_traffic(compiled):
    """Parse a compiled module's HLO for cross-device collectives and
    account their payload bytes (per device, per execution of the
    program). Returns {op_kind: {"count": n, "bytes": b}} plus a
    "total" entry. This is the number the scaling-book recipe says to
    watch: the replicated-vertex gradient reduction shows up here as
    all-reduce bytes."""
    import re

    hlo = compiled.as_text()
    out = {}
    total_b = 0
    total_n = 0
    for kind in _COLLECTIVE_OPS:
        cnt = 0
        byts = 0
        # lines look like: `%name = f32[8,3]{...} all-reduce(...)`,
        # possibly tuple-shaped: `(f32[8]{0}, f32[4]{0}) all-gather(...)`
        for m in re.finditer(
                r"= ([^=\n]*?) " + kind + r"(?:-start|-done)?\(", hlo):
            shapes = re.findall(r"(\w+)\[([\d,]*)\]", m.group(1))
            if not shapes:
                continue
            cnt += 1
            for dt, dims in shapes:
                sz = 1
                for d in dims.split(","):
                    if d:
                        sz *= int(d)
                byts += sz * _DTYPE_BYTES.get(dt, 4)
        if cnt:
            out[kind] = {"count": cnt, "bytes": byts}
            total_b += byts
            total_n += cnt
    out["total"] = {"count": total_n, "bytes": total_b}
    return out
