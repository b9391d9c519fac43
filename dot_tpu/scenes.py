"""Generated scenes: structured twist bars written as a tet mesh plus a
scene script, so benchmarks and smoke runs need no downloaded data.

The reference's bar17K_twist scene (input/bar17K_twist_DOT.txt) and its
tb1 resolution sweep (input/tb1_horse_scalab/) are stood in for by
structured bars of matched size (mesh_gen.bar_mesh, 6 Kuhn tets per
cube, 4:1:1 aspect so the twist script's x-extent handles match):

    bar17  =  56x16x16 ->  86K tets,  16.5K verts (bar17K-class)
    bar35  =  80x20x20 -> 192K tets,  35.7K verts
    bar69  = 104x25x25 -> 390K tets,  70.9K verts
    bar135 = 131x31x31 -> 755K tets, 135.2K verts (horse136K-class)
    bar265 = 165x39x39 -> 1.51M tets, 265.6K verts
"""

from __future__ import annotations

import os

BARS = {
    "bar17": (56, 16, 16),
    "bar35": (80, 20, 20),
    "bar69": (104, 25, 25),
    "bar135": (131, 31, 31),
    "bar265": (165, 39, 39),
}

# the reference's canonical bar17K_twist settings: FCR, BE, warmStart 2,
# dt 0.025, E 1e5, nu 0.4, rho 1000 (input/bar17K_twist_DOT.txt)
SCENE_TMPL = """energy {energy}
timeStepper {stepper}
warmStart 2
resolution 1000
size 1
time 5 0.025
density 1000
stiffness 100000 0.4
script {script}
shape input {mesh_path}
{extra}"""


def bar_mesh_path(root, dims):
    """Write (once) the 4:1:1 structured bar of `dims` cells under
    root/meshes and return its .msh path."""
    from .mesh_gen import bar_mesh
    from . import io as meshio

    nx, ny, nz = dims
    path = os.path.join(root, "meshes",
                        "bar" + "x".join(str(d) for d in dims) + ".msh")
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    m = bar_mesh(nx, ny, nz, size=(4.0, 1.0, 1.0))
    tmp = f"{path}.{os.getpid()}.tmp"
    meshio.save_tet_mesh(tmp, m.V, m.conn, m.SF)
    os.replace(tmp, path)
    return path


def write_bar_scene(root, dims, stepper="DOT 6", script="twist",
                    energy="FCR", extra=(), name=None):
    """Scene script for a generated bar; returns its path. `dims` is a
    BARS key or an (nx, ny, nz) cell count; `extra` holds additional
    scene-script lines (e.g. "h0Refresh 1")."""
    if isinstance(dims, str):
        dims = BARS[dims]
    mesh_path = bar_mesh_path(root, dims)
    if name is None:
        name = "_".join(["bar" + "x".join(str(d) for d in dims), script,
                         energy, stepper.replace(" ", "_")])
    scene = os.path.join(root, f"{name}.txt")
    with open(scene, "w") as f:
        f.write(SCENE_TMPL.format(
            energy=energy, stepper=stepper, script=script,
            mesh_path=os.path.abspath(mesh_path),
            extra="".join(line + "\n" for line in extra)))
    return scene
