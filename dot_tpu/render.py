"""Headless surface-mesh renderer + PNG/GIF writers.

Plays the role of the reference's GLFW viewer capture path and vendored
GIF encoder (reference: main.cpp:955-978 screenshot/GIF capture,
src/Utils/GIF.hpp): every saved frame's surface mesh can be rasterized
to a PNG and the sequence assembled into an animated GIF — but fully
headless (pure numpy z-buffer rasterizer, no GL), which is the only
sensible form on a headless accelerator host.

Rendering model: orthographic projection along -z (the reference's
default `view orthographic` camera), flat shading from a fixed headlight,
single-hue surface over a white background. Colors are emitted straight
into a 64-level shade palette so the GIF needs no quantization pass.

CLI (mesh-processing mode):
    python -m dot_tpu 2 render <run_dir> [--fps 25]   # run dir with N.obj
    python -m dot_tpu 2 screenshot <mesh.obj>         # single PNG
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# surface hue (RGB at full shade) — the reference viewer's default-ish
# warm gray; background white
_HUE = np.asarray([0.78, 0.62, 0.4])
_BG = 255


# ---------------------------------------------------------------------------
# rasterizer
# ---------------------------------------------------------------------------
def _camera_frame(V, zoom):
    """Orthographic camera: fit the bbox into the viewport with a margin,
    looking along -z, y up (reference `view orthographic`, `zoom`)."""
    lo, hi = V.min(axis=0), V.max(axis=0)
    center = 0.5 * (lo + hi)
    half = 0.5 * float((hi - lo)[:2].max()) * 1.15 / max(zoom, 1e-6)
    return center, half


def render_frames(frames, width=360, height=360, zoom=1.0):
    """Rasterize a list of (V (n,3), F (m,3)) surface meshes with a
    camera fixed to the FIRST frame's bounding box (so motion reads as
    motion). Returns a list of (H, W) uint8 shade-index images and the
    shared 256-entry RGB palette."""
    center, half = _camera_frame(frames[0][0], zoom)
    imgs = [_rasterize(V, F, width, height, center, half)
            for V, F in frames]
    return imgs, _palette()


def _rasterize(V, F, width, height, center, half, face_color=None):
    """Z-buffered flat-shaded rasterization, vectorized per triangle over
    its bounding-box pixels (offline tool; ~2s for a 20K-face mesh).
    `face_color` (optional (m,) int group ids) switches to the categorical
    field palette — the reference's scalar-field visualization role
    (getFaceFieldForVis, ADMMDDTimeStepper.cpp:516-537)."""
    # project: x right, y up, z toward viewer
    P = (V - center) / half                       # [-1, 1] box
    px = (P[:, 0] * 0.5 + 0.5) * (width - 1)
    py = (0.5 - P[:, 1] * 0.5) * (height - 1)
    pz = P[:, 2]

    # flat shading: headlight along +z
    e1 = V[F[:, 1]] - V[F[:, 0]]
    e2 = V[F[:, 2]] - V[F[:, 0]]
    n = np.cross(e1, e2)
    nn = np.linalg.norm(n, axis=1)
    nn[nn == 0] = 1.0
    shade = np.abs(n[:, 2] / nn)                  # 0..1
    if face_color is None:
        # 63 shade levels (palette indices 1..63), 0 = background
        tri_idx = (1 + np.clip(shade * 62.0, 0, 62)).astype(np.uint8)
    else:
        # field palette: indices 64.. = 24 hue groups x 8 shades
        grp = np.asarray(face_color, np.int64) % 24
        lvl = np.clip(shade * 7.0, 0, 7).astype(np.int64)
        tri_idx = (64 + grp * 8 + lvl).astype(np.uint8)

    xs = px[F]                                    # (m, 3)
    ys = py[F]
    zs = pz[F]
    zbuf = np.full((height, width), -np.inf, np.float64)
    img = np.zeros((height, width), np.uint8)

    x0 = np.maximum(np.floor(xs.min(axis=1)).astype(int), 0)
    x1 = np.minimum(np.ceil(xs.max(axis=1)).astype(int), width - 1)
    y0 = np.maximum(np.floor(ys.min(axis=1)).astype(int), 0)
    y1 = np.minimum(np.ceil(ys.max(axis=1)).astype(int), height - 1)
    # back-to-front painter order refined by a z-buffer (the z-buffer
    # alone is exact; sorting just reduces overdraw cost)
    order = np.argsort(zs.mean(axis=1))
    for t in order:
        if x1[t] < x0[t] or y1[t] < y0[t]:
            continue
        ax, ay = xs[t, 0], ys[t, 0]
        bx, by = xs[t, 1], ys[t, 1]
        cx, cy = xs[t, 2], ys[t, 2]
        den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        if den == 0.0:
            continue
        gx, gy = np.meshgrid(np.arange(x0[t], x1[t] + 1),
                             np.arange(y0[t], y1[t] + 1))
        w0 = ((by - cy) * (gx - cx) + (cx - bx) * (gy - cy)) / den
        w1 = ((cy - ay) * (gx - ax) + (ax - cx) * (gy - ay)) / den
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        z = w0 * zs[t, 0] + w1 * zs[t, 1] + w2 * zs[t, 2]
        sub_z = zbuf[y0[t]:y1[t] + 1, x0[t]:x1[t] + 1]
        sub_i = img[y0[t]:y1[t] + 1, x0[t]:x1[t] + 1]
        upd = inside & (z > sub_z)
        sub_z[upd] = z[upd]
        sub_i[upd] = tri_idx[t]
    return img


def _palette():
    """256-entry RGB palette: 0 = white background, 1..63 = shaded hue,
    64..255 = 24 categorical hues x 8 shades (field visualization)."""
    pal = np.zeros((256, 3), np.uint8)
    pal[0] = _BG
    t = np.linspace(0.15, 1.0, 63)[:, None]
    pal[1:64] = np.clip(255.0 * _HUE[None, :] * t, 0, 255).astype(np.uint8)
    hues = (np.arange(24) * 0.41735) % 1.0        # low-discrepancy hues
    for g in range(24):
        h6 = hues[g] * 6.0
        base = np.clip(np.abs((h6 - np.asarray([3.0, 2.0, 4.0])
                               + 6.0) % 6.0 - 3.0) - 1.0, 0, 1)
        lv = np.linspace(0.25, 1.0, 8)[:, None]
        pal[64 + g * 8: 64 + g * 8 + 8] = np.clip(
            255.0 * (0.25 + 0.75 * base)[None, :] * lv, 0, 255
        ).astype(np.uint8)
    return pal


def render_view(V, F, width=360, height=360, yaw=0.0, pitch=0.0, zoom=1.0,
                center=None, half=None, face_color=None):
    """One orbit-camera view: rotate the mesh by (yaw about +y, pitch
    about +x, radians) around `center` and rasterize. `center`/`half`
    pin the camera across frames (pass the rest-state values so motion
    reads as motion). Returns an (H, W) palette-index image."""
    if center is None or half is None:
        c0, h0 = _camera_frame(V, zoom)
        center = c0 if center is None else center
        half = h0 if half is None else half
    else:
        half = half / max(zoom, 1e-6)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.asarray([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Vr = (V - center) @ (Rx @ Ry).T + center
    return _rasterize(Vr, F, width, height, center, half,
                      face_color=face_color)


# ---------------------------------------------------------------------------
# PNG (single frame)
# ---------------------------------------------------------------------------
def png_bytes(img_idx, palette):
    """Encode a shade-index image as 8-bit RGB PNG bytes (zlib built-in)."""
    rgb = palette[img_idx]                        # (H, W, 3)
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path, img_idx, palette):
    """Write a shade-index image as an 8-bit RGB PNG."""
    with open(path, "wb") as f:
        f.write(png_bytes(img_idx, palette))


# ---------------------------------------------------------------------------
# GIF89a (animated, LZW-compressed) — the vendored gif.h role
# ---------------------------------------------------------------------------
def _lzw_encode(indices, min_code_size):
    """Standard GIF LZW with dynamic code growth and dictionary resets."""
    clear = 1 << min_code_size
    eoi = clear + 1
    out = bytearray()
    cur = 0
    nbits = 0

    def emit(code, size):
        nonlocal cur, nbits
        cur |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(cur & 0xFF)
            cur >>= 8
            nbits -= 8

    table = {(i,): i for i in range(clear)}
    next_code = eoi + 1
    code_size = min_code_size + 1
    emit(clear, code_size)
    seq = ()
    for px in indices:
        cand = seq + (px,)
        if cand in table:
            seq = cand
            continue
        emit(table[seq], code_size)
        table[cand] = next_code
        next_code += 1
        if next_code == (1 << code_size) + 1:
            if code_size < 12:
                code_size += 1
            else:
                emit(clear, code_size)
                table = {(i,): i for i in range(clear)}
                next_code = eoi + 1
                code_size = min_code_size + 1
        seq = (px,)
    if seq:
        emit(table[seq], code_size)
    emit(eoi, code_size)
    if nbits:
        out.append(cur & 0xFF)
    return bytes(out)


def write_gif(path, imgs, palette, fps=25):
    """Animated GIF89a from shade-index frames sharing one palette."""
    h, w = imgs[0].shape
    delay = max(2, round(100.0 / fps))
    with open(path, "wb") as f:
        f.write(b"GIF89a")
        f.write(struct.pack("<HHBBB", w, h, 0xF7, 0, 0))  # 256-color GCT
        f.write(palette.tobytes())
        # looping application extension
        f.write(b"\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00")
        for img in imgs:
            # GCE: ext, label, size, packed, delay, transparent idx, term
            f.write(struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0, delay, 0, 0))
            f.write(struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0))
            f.write(b"\x08")                      # LZW min code size
            data = _lzw_encode(img.reshape(-1).tolist(), 8)
            for i in range(0, len(data), 255):
                blk = data[i:i + 255]
                f.write(bytes([len(blk)]) + blk)
            f.write(b"\x00")
        f.write(b"\x3B")


# ---------------------------------------------------------------------------
# run-directory driver
# ---------------------------------------------------------------------------
def render_run_dir(run_dir, fps=25, width=360, height=360, zoom=1.0,
                   png_every=0):
    """Render every saved `<n>.obj` of a simulation run directory into
    `anim.gif`, plus the reference's per-run still captures `0.png`
    (first frame) and `finalResult.png` (last frame) — the offline
    equivalent of the reference viewer's capture loop (main.cpp:955-978;
    still captures main.cpp:318-358). Optionally also PNGs every
    `png_every` frames."""
    from . import io as meshio
    objs = []
    for name in os.listdir(run_dir):
        if name.endswith(".obj") and name[:-4].isdigit():
            objs.append((int(name[:-4]), os.path.join(run_dir, name)))
    if not objs:
        raise FileNotFoundError(f"no <n>.obj frames in {run_dir}")
    objs.sort()
    frames = [meshio.read_obj(p) for _, p in objs]
    imgs, pal = render_frames(frames, width, height, zoom)
    gif_path = os.path.join(run_dir, "anim.gif")
    write_gif(gif_path, imgs, pal, fps=fps)
    write_png(os.path.join(run_dir, "0.png"), imgs[0], pal)
    write_png(os.path.join(run_dir, "finalResult.png"), imgs[-1], pal)
    if png_every:
        for (n, _), img in zip(objs, imgs):
            if n % png_every == 0:
                write_png(os.path.join(run_dir, f"{n}.png"), img, pal)
    return gif_path
