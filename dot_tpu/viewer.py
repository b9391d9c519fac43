"""Interactive simulation viewer served over HTTP.

The counterpart of the reference's GLFW/libigl viewer loop
(main.cpp:955-978: per-frame redraw, space = pause/resume, '/' = single
step; scalar-field subdomain visualization getFaceFieldForVis,
ADMMDDTimeStepper.cpp:516-537). The simulation usually runs on a
headless accelerator host, so the viewer is a tiny dependency-free HTTP
server + vanilla-JS page: the simulation thread publishes each frame's
surface positions, the browser orbits / zooms / pauses, and views are rasterized on demand by the same z-buffer
renderer that writes the per-run PNG/GIF artifacts (render.py).

Usage: `python -m dot_tpu 0 scene.txt` (mode 0 = interactive, as in the
reference) — prints the URL, steps the scene, stays serving after the
last frame until Ctrl-C.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

import numpy as np

from . import render

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>dot_tpu viewer</title><style>
body{font-family:system-ui,sans-serif;background:#16161a;color:#eee;
     display:flex;flex-direction:column;align-items:center;margin:0}
#bar{padding:8px;display:flex;gap:8px;align-items:center}
button{background:#2a2a31;color:#eee;border:1px solid #444;
       border-radius:4px;padding:4px 12px;cursor:pointer}
button:hover{background:#3a3a44}
#st{font-size:13px;color:#9a9aa5;padding:4px}
canvas{border:1px solid #333;cursor:grab;touch-action:none}
</style></head><body>
<div id="bar">
 <button id="pp">pause</button>
 <button id="step">step</button>
 <button id="field">field: shade</button>
 <span id="st"></span>
</div>
<canvas id="cv" width="{W}" height="{H}"></canvas>
<div id="st2" style="font-size:12px;color:#777;padding:6px">
 drag = orbit &middot; wheel = zoom &middot; space = pause &middot;
 / = step (reference key bindings)</div>
<script>
let yaw=0,pitch=0,zoom=1,paused=false,fieldOn=false,drag=null,inflight=false;
const cv=document.getElementById('cv'),ctx=cv.getContext('2d');
function draw(){
  if(inflight)return; inflight=true;
  const img=new Image();
  img.onload=()=>{ctx.drawImage(img,0,0);inflight=false;};
  img.onerror=()=>{inflight=false;};
  img.src=`/frame.png?yaw=${yaw}&pitch=${pitch}&zoom=${zoom}`+
          `&field=${fieldOn?1:0}&t=${Date.now()}`;
}
async function poll(){
  try{
    const s=await (await fetch('/state')).json();
    document.getElementById('st').textContent=
      `frame ${s.frame}  sysE ${s.sys_e}  ${s.running?'':'(done)'}`;
    document.getElementById('pp').textContent=s.paused?'resume':'pause';
    paused=s.paused;
    if(s.seq!==window._seq){window._seq=s.seq;draw();}
  }catch(e){}
  setTimeout(poll,500);
}
cv.onpointerdown=e=>{drag=[e.clientX,e.clientY];cv.setPointerCapture(e.pointerId);};
cv.onpointerup=e=>{drag=null;};
cv.onpointermove=e=>{
  if(!drag)return;
  yaw+=(e.clientX-drag[0])*0.01; pitch+=(e.clientY-drag[1])*0.01;
  drag=[e.clientX,e.clientY]; draw();
};
cv.onwheel=e=>{e.preventDefault();zoom*=Math.exp(-e.deltaY*0.001);draw();};
document.getElementById('pp').onclick=()=>fetch('/cmd?op='+(paused?'resume':'pause'));
document.getElementById('step').onclick=()=>fetch('/cmd?op=step');
document.getElementById('field').onclick=function(){
  fieldOn=!fieldOn;this.textContent='field: '+(fieldOn?'subdomain':'shade');draw();};
window.onkeydown=e=>{
  if(e.key===' '){e.preventDefault();document.getElementById('pp').click();}
  if(e.key==='/'){document.getElementById('step').click();}};
poll();draw();
</script></body></html>"""


class LiveViewer:
    """Publish-subscribe bridge between the frame loop and the browser.

    The simulation thread calls `submit()` per frame and `wait_if_paused()`
    at the top of each step; HTTP handlers read the latest snapshot under
    a lock and rasterize the requested view."""

    def __init__(self, faces, face_part=None, width=360, height=360,
                 port=0, zoom=1.0):
        self.faces = np.asarray(faces)
        self.face_part = (None if face_part is None
                          else np.asarray(face_part))
        self.width, self.height = width, height
        self.base_zoom = zoom
        self._lock = threading.Lock()
        self._V = None
        self._center = None
        self._half = None
        self._info = {"frame": 0, "sys_e": float("nan"), "running": True}
        self._seq = 0
        self._palette = render._palette()
        self._paused = threading.Event()
        self._step_once = threading.Event()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet server
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)

                def f(key, dflt):
                    try:
                        return float(q.get(key, [dflt])[0])
                    except ValueError:
                        return dflt

                try:
                    if u.path == "/":
                        page = (_PAGE.replace("{W}", str(viewer.width))
                                     .replace("{H}", str(viewer.height)))
                        self._send(200, "text/html", page.encode())
                    elif u.path == "/frame.png":
                        body = viewer.render_view(
                            yaw=f("yaw", 0.0), pitch=f("pitch", 0.0),
                            zoom=f("zoom", 1.0),
                            field=q.get("field", ["0"])[0] == "1")
                        if body is None:
                            self._send(503, "text/plain", b"no frame yet")
                        else:
                            self._send(200, "image/png", body)
                    elif u.path == "/state":
                        self._send(200, "application/json",
                                   json.dumps(viewer.state()).encode())
                    elif u.path == "/cmd":
                        viewer.command(q.get("op", [""])[0])
                        self._send(200, "text/plain", b"ok")
                    else:
                        self._send(404, "text/plain", b"not found")
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}/"

    # ---- simulation side -------------------------------------------------
    def submit(self, V, frame, sys_e=float("nan")):
        """Publish this frame's surface positions (numpy (nSV, 3))."""
        V = np.asarray(V, np.float64)
        with self._lock:
            if self._center is None:
                c, h = render._camera_frame(V, self.base_zoom)
                self._center, self._half = c, h
            self._V = V
            self._info = {"frame": int(frame), "sys_e": float(sys_e),
                          "running": True}
            self._seq += 1

    def finish(self):
        with self._lock:
            self._info["running"] = False
            self._seq += 1

    def wait_if_paused(self):
        """Block while paused; a queued 'step' releases one frame."""
        while self._paused.is_set():
            if self._step_once.is_set():
                self._step_once.clear()
                return
            time.sleep(0.05)

    def serve_forever(self):
        """Keep serving after the run (reference mode-0 window stays
        open); returns on Ctrl-C."""
        try:
            while True:
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass

    def close(self):
        self._server.shutdown()

    # ---- HTTP side ---------------------------------------------------------
    def state(self):
        with self._lock:
            info = dict(self._info)
        info["paused"] = self._paused.is_set()
        info["seq"] = self._seq
        se = info["sys_e"]
        info["sys_e"] = "—" if np.isnan(se) else f"{se:.6e}"
        return info

    def command(self, op):
        if op == "pause":
            self._paused.set()
        elif op == "resume":
            self._paused.clear()
        elif op == "step":
            self._step_once.set()

    def render_view(self, yaw=0.0, pitch=0.0, zoom=1.0, field=False):
        with self._lock:
            V = self._V
            center, half = self._center, self._half
        if V is None:
            return None
        fc = self.face_part if field else None
        img = render.render_view(
            V, self.faces, self.width, self.height, yaw=yaw, pitch=pitch,
            zoom=zoom, center=center, half=half, face_color=fc)
        return render.png_bytes(img, self._palette)


def surface_face_parts(mesh, part):
    """Map each surface triangle to the partition id of the unique tet it
    belongs to (the subdomain scalar field of getFaceFieldForVis)."""
    combos = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))
    nv = np.int64(mesh.n_vert)
    tri = np.sort(np.concatenate([mesh.conn[:, c] for c in combos]),
                  axis=1).astype(np.int64)
    keys = (tri[:, 0] * nv + tri[:, 1]) * nv + tri[:, 2]
    elems = np.tile(np.arange(mesh.n_elem, dtype=np.int64), 4)
    order = np.argsort(keys, kind="stable")
    sf = np.sort(mesh.SF.astype(np.int64), axis=1)
    want = (sf[:, 0] * nv + sf[:, 1]) * nv + sf[:, 2]
    # surface faces appear exactly once in the face multiset
    pos = np.searchsorted(keys[order], want)
    return np.asarray(part)[elems[order[pos]]].astype(np.int32)
