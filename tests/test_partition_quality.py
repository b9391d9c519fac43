"""Multilevel k-way partitioner validity + quality (native/mlkway.cpp;
reference role: METIS<3>::partMesh, METIS.hpp:109-160 — k-way edge-cut
minimization with contiguity, min-connectivity, ufactor=30 balance)."""

import numpy as np
import pytest

from dot_tpu import native, partition
from dot_tpu.mesh_gen import bar_mesh


def _dual_adjacency(conn):
    """(elem, elem) pairs sharing a face."""
    faces = {}
    pairs = []
    combos = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
    for e, tet in enumerate(conn):
        for c in combos:
            key = tuple(sorted(tet[list(c)]))
            other = faces.pop(key, None)
            if other is None:
                faces[key] = e
            else:
                pairs.append((other, e))
    return pairs


@pytest.fixture(scope="module")
def mesh():
    return bar_mesh(10, 4, 4)


def test_partition_valid_and_balanced(mesh):
    res = native.partition_mesh_dual(mesh.conn, 6)
    assert res is not None, "native partitioner must be available in CI"
    part, cut = res
    assert part.shape == (mesh.n_elem,)
    assert set(np.unique(part)) == set(range(6))
    sizes = np.bincount(part, minlength=6)
    # ufactor=30-style balance plus slack for contiguity repair
    assert sizes.max() <= 1.10 * mesh.n_elem / 6 + 1

    # reported edge cut matches a direct count
    pairs = _dual_adjacency(mesh.conn)
    direct = sum(1 for a, b in pairs if part[a] != part[b])
    assert direct == cut


def test_partition_contiguous(mesh):
    part, _ = native.partition_mesh_dual(mesh.conn, 6)
    pairs = _dual_adjacency(mesh.conn)
    adj = [[] for _ in range(mesh.n_elem)]
    for a, b in pairs:
        adj[a].append(b)
        adj[b].append(a)
    for p in range(6):
        elems = np.where(part == p)[0]
        seen = {elems[0]}
        stack = [elems[0]]
        inpart = set(elems.tolist())
        while stack:
            v = stack.pop()
            for u in adj[v]:
                if u in inpart and u not in seen:
                    seen.add(u)
                    stack.append(u)
        assert len(seen) == len(elems), f"part {p} is disconnected"


def test_partition_beats_or_ties_rcb_interface(mesh):
    """The point of the multilevel partitioner: fewer duplicated interface
    vertices than plain coordinate bisection (H0 quality gate)."""
    part, _ = partition.element_partition(mesh, 6)
    cent = mesh.V_rest[mesh.conn].mean(axis=1)
    rcb = partition.rcb_partition(cent, 6)
    i_sel = partition._interface_count(mesh.conn, part, mesh.n_vert, 6)
    i_rcb = partition._interface_count(mesh.conn, rcb, mesh.n_vert, 6)
    assert i_sel <= i_rcb


def test_partition_deterministic(mesh):
    p1, c1 = native.partition_mesh_dual(mesh.conn, 4)
    p2, c2 = native.partition_mesh_dual(mesh.conn, 4)
    assert c1 == c2 and np.array_equal(p1, p2)


# ---------------------------------------------------------------------
# partition-scheme variants (the reference's compile-time USE_METIS 2-4
# selector, ADMMDDTimeStepper.cpp:88-152 + METIS.hpp:213-231)
# ---------------------------------------------------------------------

def test_slice_partition(mesh):
    """partMesh_slice role: equal-width slabs along an axis."""
    part = partition.slice_partition(mesh, 5, axis=0)
    cent = mesh.V_rest[mesh.conn].mean(axis=1)[:, 0]
    lo, hi = mesh.V_rest[:, 0].min(), mesh.V_rest[:, 0].max()
    expect = np.clip(((cent - lo) / ((hi - lo) / 5)).astype(int), 0, 4)
    assert np.array_equal(part, expect)
    assert set(np.unique(part)) == set(range(5))
    # slabs are monotone in x: max centroid of slab p < min of slab p+2
    for p in range(4):
        assert cent[part == p].max() <= cent[part == p + 1].max()


def _brute_vneighbor(conn, n_vert):
    nb = [set() for _ in range(n_vert)]
    for tet in conn:
        for i in range(4):
            for j in range(4):
                if i != j:
                    nb[tet[i]].add(tet[j])
    return nb


def test_surface_distance_weights(mesh):
    """USE_METIS==3 weights: BFS vertex distance to the surface, summed
    over element corners — checked against a brute-force BFS."""
    w = partition.surface_distance_weights(mesh)
    nb = _brute_vneighbor(mesh.conn, mesh.n_vert)
    from collections import deque
    dist = np.full(mesh.n_vert, -1)
    q = deque()
    for v in np.unique(mesh.SF.ravel()):
        dist[v] = 0
        q.append(v)
    while q:
        v = q.popleft()
        for u in nb[v]:
            if dist[u] < 0:
                dist[u] = dist[v] + 1
                q.append(u)
    assert np.array_equal(w, dist[mesh.conn].sum(axis=1))


def test_degree_weights(mesh):
    """USE_METIS==4 weights: sum over corners of (valence + 1)."""
    w = partition.degree_weights(mesh)
    nb = _brute_vneighbor(mesh.conn, mesh.n_vert)
    deg = np.array([len(s) + 1 for s in nb])
    assert np.array_equal(w, deg[mesh.conn].sum(axis=1))


def test_weighted_partition_balances_weight(mesh):
    """Weighted k-way balances total element WEIGHT per part (the METIS
    vwgt contract), not element count."""
    w = partition.degree_weights(mesh)
    res = native.partition_mesh_dual(mesh.conn, 4, elem_wgt=w)
    assert res is not None
    part, _cut = res
    assert set(np.unique(part)) == set(range(4))
    pw = np.bincount(part, weights=w.astype(np.float64), minlength=4)
    # imbalance 1.03 plus slack for contiguity repair
    assert pw.max() <= 1.12 * w.sum() / 4


def test_scheme_plans_run_end_to_end(mesh):
    """build_plan under schemes 2/3 feeds the same downstream machinery:
    one DOT step must run and decrease the energy like scheme 1."""
    import jax.numpy as jnp
    from dot_tpu.config import Config
    from dot_tpu import scripts
    from dot_tpu.steppers import System, DOTStepper

    for scheme in (2, 3):
        cfg = Config(energy="FCR", dt=0.025, rho=1000.0, ym=1e5, pr=0.4,
                     script="twist", handle_ratio=0.05,
                     partition_scheme=scheme)
        m = type(mesh)(mesh.V_rest.copy(), mesh.conn.copy(),
                       SF=mesh.SF.copy(), ym=cfg.ym, pr=cfg.pr, rho=cfg.rho)
        m.find_border_verts(cfg.handle_ratio)
        sd = scripts.init_script(m, "twist")
        m.fixed_mask = sd.fixed0.copy()
        plan = partition.build_plan(m, 3, pad_elem_to=16, pad_n3_to=48,
                                    scheme=scheme)
        stepper = DOTStepper(System(m, cfg, plan, dtype=jnp.float64), sd)
        st = stepper.init_state()
        st, (stats, sys_e) = stepper.step(st)
        assert np.isfinite(float(sys_e))
