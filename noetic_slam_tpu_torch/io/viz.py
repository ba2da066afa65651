"""Headless visualization — the ouster_viz replacement.

The reference vendors an OpenGL/GLFW interactive viewer
(src/ouster/ouster-sdk/ouster_viz/, ~6.5k LoC: point cloud rendering with
palette coloring, 2D range/signal image strips, camera orbit/dolly). A GL
window is useless on a headless TPU pod, so this module provides the same
*products* in forms that fit the deployment:

- ``render_cloud``: dependency-free numpy z-buffer point splatting with a
  perspective camera -> (H, W, 3) uint8 frame (palette colorings matching
  the viewer's Cal Ref / grey ramps).
- ``render_views``: the standard 4-panel contact sheet (top / front / side /
  isometric orbit view).
- ``render_scan_panels``: stacked destaggered sensor image strips (range /
  signal / reflectivity / NIR), the viz "2D images" pane
  (ouster_viz/src/viz.cpp image widgets).
- ``write_png``: minimal stdlib PNG encoder (zlib), no imaging deps.
- ``write_html_viewer``: one self-contained .html with the point cloud
  embedded + a ~100-line canvas orbit renderer — the interactive camera
  (rotate / zoom) role of the GL viewer, viewable anywhere.

Everything is host-side numpy on data already pulled from device (maps,
scans, trajectories are small compared to training traffic).

The port's own copy of ``noetic_slam_tpu.io.viz`` (it imports nothing of the
JAX package); ``tests/test_torch_ingest.py`` holds it to the original.
"""

from __future__ import annotations

import base64
import json
import struct
import zlib

import numpy as np

__all__ = [
    "colorize",
    "render_cloud",
    "render_views",
    "render_scan_panels",
    "render_trajectory",
    "write_png",
    "write_html_viewer",
]


# --------------------------------------------------------------------- color
# Compact turbo-like palette (matches the viewer's default rainbow ramp
# role; anchor points of Google's Turbo, linearly interpolated).
_TURBO_ANCHORS = np.array([
    [48, 18, 59], [70, 107, 227], [40, 187, 236], [31, 233, 175],
    [122, 252, 82], [218, 227, 56], [255, 165, 49], [241, 80, 29],
    [177, 18, 3], [122, 4, 3]], np.float32) / 255.0


def colorize(values: np.ndarray, cmap: str = "turbo",
             lo: float | None = None, hi: float | None = None) -> np.ndarray:
    """(N,) scalars -> (N, 3) float RGB in [0,1]; percentile-stretched."""
    v = np.asarray(values, np.float32)
    finite = np.isfinite(v)
    if lo is None:
        lo = float(np.percentile(v[finite], 2.0)) if finite.any() else 0.0
    if hi is None:
        hi = float(np.percentile(v[finite], 98.0)) if finite.any() else 1.0
    t = np.clip((v - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    t = np.where(finite, t, 0.0)
    if cmap == "grey":
        return np.repeat(t[:, None], 3, axis=-1)
    x = t * (len(_TURBO_ANCHORS) - 1)
    i = np.clip(x.astype(int), 0, len(_TURBO_ANCHORS) - 2)
    f = (x - i)[:, None]
    return _TURBO_ANCHORS[i] * (1 - f) + _TURBO_ANCHORS[i + 1] * f


# -------------------------------------------------------------------- camera
def _look_at(eye: np.ndarray, center: np.ndarray, up=(0.0, 0.0, 1.0)):
    f = center - eye
    f = f / max(np.linalg.norm(f), 1e-12)
    up = np.asarray(up, np.float64)
    s = np.cross(f, up)
    s = s / max(np.linalg.norm(s), 1e-12)
    u = np.cross(s, f)
    R = np.stack([s, u, -f])          # world -> camera rows
    return R, eye


def render_cloud(xyz: np.ndarray, rgb: np.ndarray | None = None,
                 width: int = 960, height: int = 720,
                 eye=None, center=None, fov_deg: float = 60.0,
                 point_px: int = 2, background=(12, 12, 16)) -> np.ndarray:
    """Perspective z-buffer point splatting -> (H, W, 3) uint8.

    Painter-correct via depth sort (far first); each point splats a
    ``point_px`` square. ~10^6 points render in tens of ms of numpy.
    """
    xyz = np.asarray(xyz, np.float64)
    ok = np.all(np.isfinite(xyz), axis=-1) & (np.abs(xyz) < 1e5).all(axis=-1)
    xyz = xyz[ok]
    if rgb is None:
        rgb = colorize(xyz[:, 2] if len(xyz) else np.zeros(0))
    else:
        rgb = np.asarray(rgb, np.float32)[ok]

    img = np.empty((height, width, 3), np.uint8)
    img[:] = np.asarray(background, np.uint8)
    if len(xyz) == 0:
        return img

    c = np.median(xyz, axis=0) if center is None else np.asarray(center)
    if eye is None:
        ext = float(np.percentile(np.linalg.norm(xyz - c, axis=-1), 95))
        eye = c + np.array([-1.2, -1.2, 0.8]) * max(ext, 1.0)
    R, e = _look_at(np.asarray(eye, np.float64), c)
    pc = (xyz - e) @ R.T
    z = -pc[:, 2]
    vis = z > 1e-3
    pc, z, col = pc[vis], z[vis], rgb[vis]

    f = 0.5 * height / np.tan(np.radians(fov_deg) * 0.5)
    u = (f * pc[:, 0] / z + width * 0.5).astype(int)
    v = (-f * pc[:, 1] / z + height * 0.5).astype(int)
    inside = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    u, v, z, col = u[inside], v[inside], z[inside], col[inside]

    order = np.argsort(-z)            # far first; near overwrites
    u, v, col = u[order], v[order], (col[order] * 255).astype(np.uint8)
    r = max(point_px // 2, 0)
    for dy in range(-r, r + 1):
        vy = np.clip(v + dy, 0, height - 1)
        for dx in range(-r, r + 1):
            ux = np.clip(u + dx, 0, width - 1)
            img[vy, ux] = col
    return img


def render_views(xyz: np.ndarray, rgb: np.ndarray | None = None,
                 size: int = 480) -> np.ndarray:
    """4-panel contact sheet: top / front / side / isometric."""
    xyz = np.asarray(xyz, np.float64)
    ok = np.all(np.isfinite(xyz), axis=-1) & (np.abs(xyz) < 1e5).all(axis=-1)
    p = xyz[ok]
    c = np.median(p, axis=0) if len(p) else np.zeros(3)
    ext = (float(np.percentile(np.linalg.norm(p - c, axis=-1), 95))
           if len(p) else 1.0)
    d = max(ext, 1.0) * 2.2
    eyes = [c + np.array([0, -1e-4, 1]) * d,       # top
            c + np.array([0, -1, 0.05]) * d,       # front
            c + np.array([-1, 0, 0.05]) * d,       # side
            c + np.array([-0.8, -0.8, 0.55]) * d]  # iso
    tiles = [render_cloud(xyz, rgb, width=size, height=size, eye=e, center=c)
             for e in eyes]
    top = np.concatenate(tiles[:2], axis=1)
    bot = np.concatenate(tiles[2:], axis=1)
    return np.concatenate([top, bot], axis=0)


def render_trajectory(positions: np.ndarray, size: int = 640,
                      margin: float = 0.08) -> np.ndarray:
    """Top-down XY trajectory plot -> (size, size, 3) uint8 (start green,
    end red, path colored by time)."""
    img = np.full((size, size, 3), 250, np.uint8)
    p = np.asarray(positions, np.float64)
    if len(p) < 2:
        return img
    lo = p[:, :2].min(axis=0)
    hi = p[:, :2].max(axis=0)
    span = max(float((hi - lo).max()), 1e-6)
    o = lo - (span * margin)
    scale = size * (1 - 2 * margin) / span

    # dense interpolation so segments draw as continuous dots
    t = np.linspace(0, 1, len(p))
    ti = np.linspace(0, 1, max(len(p) * 8, 256))
    x = np.interp(ti, t, (p[:, 0] - o[0]) * scale)
    y = np.interp(ti, t, (p[:, 1] - o[1]) * scale)
    col = (colorize(ti, "turbo", 0, 1) * 255).astype(np.uint8)
    xi = np.clip(x.astype(int), 0, size - 1)
    yi = np.clip(size - 1 - y.astype(int), 0, size - 1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            img[np.clip(yi + dy, 0, size - 1),
                np.clip(xi + dx, 0, size - 1)] = col
    return img


def render_scan_panels(images: dict, gap: int = 4) -> np.ndarray:
    """Stack destaggered sensor image products (io.ouster.scan_images
    output) into one (sum H, W, 3) strip panel, one colormapped row block
    per product (the viewer's 2D image pane)."""
    keys = [k for k in ("range", "signal_norm", "reflectivity_norm",
                        "near_ir_norm", "signal", "reflectivity", "near_ir")
            if k in images][:4]
    rows = []
    width = max(images[k].shape[1] for k in keys)
    for k in keys:
        im = np.asarray(images[k], np.float32)
        rgbrow = colorize(im.reshape(-1),
                          "grey" if k.endswith("_norm") else "turbo")
        block = (rgbrow.reshape(im.shape + (3,)) * 255).astype(np.uint8)
        if block.shape[1] < width:
            pad = np.zeros((block.shape[0], width - block.shape[1], 3),
                           np.uint8)
            block = np.concatenate([block, pad], axis=1)
        rows.append(block)
        rows.append(np.zeros((gap, width, 3), np.uint8))
    return np.concatenate(rows[:-1], axis=0)


# ----------------------------------------------------------------------- png
def write_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG encoder (8-bit RGB), stdlib-only."""
    img = np.ascontiguousarray(np.asarray(img, np.uint8))
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", ihdr))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))


# ---------------------------------------------------------------------- html
_HTML = """<!doctype html><meta charset="utf-8">
<title>noetic_slam_tpu viewer</title>
<style>body{margin:0;background:#0c0c10;color:#ccc;font:12px monospace}
#hud{position:fixed;left:8px;top:8px}</style>
<canvas id=c></canvas><div id=hud>drag: orbit &nbsp; wheel: zoom &nbsp;
shift-drag: pan &nbsp; N=%NPTS%</div>
<script>
const B64="%DATA%";
const bin=atob(B64);const n=bin.length/15;  // 3 f32 + 3 u8 per point
const buf=new ArrayBuffer(bin.length);const u8=new Uint8Array(buf);
for(let i=0;i<bin.length;i++)u8[i]=bin.charCodeAt(i);
const xyz=new Float32Array(buf,0,n*3);const col=new Uint8Array(buf,n*12,n*3);
const cv=document.getElementById('c');const ctx=cv.getContext('2d');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw()}
onresize=rs;
let cx=0,cy=0,cz=0;for(let i=0;i<n;i++){cx+=xyz[3*i];cy+=xyz[3*i+1];cz+=xyz[3*i+2]}
cx/=n;cy/=n;cz/=n;
let yaw=-0.8,pitch=0.5,dist=0,panx=0,pany=0;
for(let i=0;i<n;i++){const dx=xyz[3*i]-cx,dy=xyz[3*i+1]-cy,dz=xyz[3*i+2]-cz;
dist=Math.max(dist,Math.hypot(dx,dy,dz))}dist*=1.6;dist=Math.max(dist,1);
function draw(){
 ctx.fillStyle='#0c0c10';ctx.fillRect(0,0,W,H);
 const sy=Math.sin(yaw),cyw=Math.cos(yaw),sp=Math.sin(pitch),cp=Math.cos(pitch);
 const f=0.9*H;const im=ctx.createImageData(W,H);const px=im.data;
 const zb=new Float32Array(W*H).fill(1e30);
 for(let i=0;i<n;i++){
  let x=xyz[3*i]-cx,y=xyz[3*i+1]-cy,z=xyz[3*i+2]-cz;
  let x1=cyw*x+sy*y, y1=-sy*x+cyw*y;           // yaw about z
  let y2=cp*y1+sp*z, z2=-sp*y1+cp*z;           // pitch
  const zc=y2+dist; if(zc<0.05)continue;
  const u=(f*x1/zc+W/2+panx)|0, v=(H/2-f*z2/zc+pany)|0;
  if(u<1||u>=W-1||v<1||v>=H-1)continue;
  for(let dy2=0;dy2<2;dy2++)for(let dx2=0;dx2<2;dx2++){
   const o=(v+dy2)*W+(u+dx2);
   if(zc<zb[o]){zb[o]=zc;const p4=o*4;
    px[p4]=col[3*i];px[p4+1]=col[3*i+1];px[p4+2]=col[3*i+2];px[p4+3]=255}}}
 ctx.putImageData(im,0,0)}
let drag=false,lx=0,ly=0,pan=false;
cv.onmousedown=e=>{drag=true;pan=e.shiftKey;lx=e.clientX;ly=e.clientY};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;const dx=e.clientX-lx,dy=e.clientY-ly;
 lx=e.clientX;ly=e.clientY;
 if(pan){panx+=dx;pany+=dy}else{yaw+=dx*0.005;pitch+=dy*0.005;
 pitch=Math.max(-1.55,Math.min(1.55,pitch))}requestAnimationFrame(draw)};
onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);requestAnimationFrame(draw)};
rs();
</script>"""


def write_html_viewer(path: str, xyz: np.ndarray,
                      rgb: np.ndarray | None = None,
                      max_points: int = 400_000) -> None:
    """Write a single self-contained interactive orbit viewer (.html).

    The interactive-camera role of ouster_viz (orbit / zoom / pan) without
    a GL context: points + colors are embedded base64, rendered by an
    inline canvas splatter. Subsamples to ``max_points``.
    """
    xyz = np.asarray(xyz, np.float32)
    ok = np.all(np.isfinite(xyz), axis=-1) & (np.abs(xyz) < 1e5).all(axis=-1)
    xyz = xyz[ok]
    if rgb is None:
        rgb = colorize(xyz[:, 2] if len(xyz) else np.zeros(0))
    else:
        rgb = np.asarray(rgb, np.float32)[ok]
    if len(xyz) > max_points:
        sel = np.random.default_rng(0).choice(len(xyz), max_points,
                                              replace=False)
        xyz, rgb = xyz[sel], rgb[sel]
    blob = xyz.astype("<f4").tobytes() + (
        np.clip(rgb * 255, 0, 255).astype(np.uint8).tobytes())
    html = (_HTML.replace("%DATA%", base64.b64encode(blob).decode())
                 .replace("%NPTS%", str(len(xyz))))
    with open(path, "w") as fh:
        fh.write(html)
