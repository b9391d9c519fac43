"""Interactive viewer (dot_tpu/viewer.py) — the reference mode-0 GLFW
window's role (main.cpp:955-978): live frame publishing, orbit/zoom
re-rendering, pause/step control, subdomain scalar field
(getFaceFieldForVis, ADMMDDTimeStepper.cpp:516-537)."""

import json
import urllib.request

import numpy as np

from dot_tpu.mesh_gen import bar_mesh
from dot_tpu import partition
from dot_tpu.viewer import LiveViewer, surface_face_parts


def test_viewer_endpoints_and_control():
    mesh = bar_mesh(6, 3, 3)
    part, _ = partition.element_partition(mesh, 3)
    fp = surface_face_parts(mesh, part)
    assert fp.shape == (mesh.SF.shape[0],)
    assert set(np.unique(fp)) <= set(range(3))

    sf = mesh.SF
    surf = np.unique(sf.ravel())
    remap = np.full(mesh.n_vert, -1)
    remap[surf] = np.arange(len(surf))
    v = LiveViewer(remap[sf], face_part=fp, width=64, height=64)
    try:
        # before any frame: 503-equivalent (None)
        assert v.render_view() is None
        v.submit(mesh.V[surf], frame=0, sys_e=1.25)

        png = v.render_view(yaw=0.4, pitch=0.2, zoom=1.5)
        assert png is not None and png[:4] == b"\x89PNG"
        png_field = v.render_view(field=True)
        assert png_field[:4] == b"\x89PNG" and png_field != png

        # control protocol: pause blocks, step releases one frame
        v.command("pause")
        assert v.state()["paused"]
        v.command("step")
        v.wait_if_paused()          # returns immediately (step queued)
        v.command("resume")
        assert not v.state()["paused"]

        # one real HTTP round-trip
        with urllib.request.urlopen(v.url + "state", timeout=10) as r:
            st = json.loads(r.read())
        assert st["frame"] == 0 and st["sys_e"].startswith("1.25")
        with urllib.request.urlopen(
                v.url + "frame.png?yaw=0.1", timeout=30) as r:
            assert r.read()[:4] == b"\x89PNG"
        with urllib.request.urlopen(v.url, timeout=10) as r:
            assert b"<canvas" in r.read()
    finally:
        v.close()
