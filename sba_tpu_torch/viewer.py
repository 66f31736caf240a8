"""Self-contained HTML model viewer (the GUI substitute).

Port of ``sba_tpu/viewer.py`` (host code; the same page and payload).

Capability counterpart of ref: src/ui/ (Qt5 `MainWindow` + OpenGL point/
camera painters, ui/main_window.h:61, ui/point_painter.cc). A desktop Qt
GUI has no place in a TPU/headless deployment; the interactive-inspection
capability is preserved as a single-file HTML export: point cloud +
camera frusta with drag-to-rotate / wheel-zoom, zero external assets.
"""

from __future__ import annotations

import json

import numpy as np


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>sba_tpu model viewer</title>
<style>
 body {{ margin: 0; background: {background}; color: #ddd;
        font-family: monospace; overflow: hidden; }}
 #hud {{ position: fixed; top: 8px; left: 8px; font-size: 12px; }}
 canvas {{ display: block; }}
</style></head>
<body>
<div id="hud">{title} — {num_points} points, {num_cameras} cameras<br>
drag: rotate &nbsp; wheel: zoom &nbsp; shift-drag: pan &nbsp;
r: orbit movie &nbsp; click: pick camera/point<br>
<span id="pick"></span></div>
<canvas id="c"></canvas>
<script>
let PTS = {points_json};
let COL = {colors_json};
let IDS = {point_ids_json};
let CAMS = {cameras_json};
let CAM_NAMES = {camera_names_json};
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
let yaw = 0.5, pitch = -0.4, dist = {initial_dist}, panX = 0, panY = 0;
let spinning = {animate_json};
const PS = {point_size};
let center = {center_json};
function resize() {{
  canvas.width = innerWidth; canvas.height = innerHeight; draw();
}}
addEventListener('resize', resize);
let dragging = false, panning = false, lx = 0, ly = 0, moved = 0;
let selCam = -1, selPt = -1;
canvas.onmousedown = e => {{
  dragging = true; panning = e.shiftKey; lx = e.clientX; ly = e.clientY;
  moved = 0;
}};
addEventListener('mouseup', e => {{
  dragging = false;
  if (moved < 4) pick(e.clientX, e.clientY);
}});
// Click picking: nearest camera apex within 10 px wins, else the
// nearest projected point within 6 px (the ui/ click-to-select
// capability of the reference's Qt viewer, headless).
function pick(mx, my) {{
  const hud = document.getElementById('pick');
  selCam = -1; selPt = -1;
  let best = 10 * 10;
  for (let i = 0; i < CAMS.length; i++) {{
    const a = project(CAMS[i][0]);
    if (!a) continue;
    const d = (a[0] - mx) ** 2 + (a[1] - my) ** 2;
    if (d < best) {{ best = d; selCam = i; }}
  }}
  if (selCam >= 0) {{
    const c = CAMS[selCam][0];
    hud.textContent = 'image ' + CAM_NAMES[selCam] + '  center (' +
      c.map(v => v.toFixed(2)).join(', ') + ')';
    draw(); return;
  }}
  best = 6 * 6;
  for (let i = 0; i < PTS.length; i++) {{
    const s = project(PTS[i]);
    if (!s) continue;
    const d = (s[0] - mx) ** 2 + (s[1] - my) ** 2;
    if (d < best) {{ best = d; selPt = i; }}
  }}
  if (selPt >= 0) {{
    const p = PTS[selPt];
    hud.textContent = 'point3D ' + IDS[selPt] + '  (' +
      p.map(v => v.toFixed(3)).join(', ') + ')';
  }} else hud.textContent = '';
  draw();
}}
addEventListener('mousemove', e => {{
  if (!dragging) return;
  const dx = e.clientX - lx, dy = e.clientY - ly;
  moved += Math.abs(dx) + Math.abs(dy);
  if (panning) {{ panX += dx; panY += dy; }}
  else {{ yaw += dx * 0.008; pitch += dy * 0.008; }}
  lx = e.clientX; ly = e.clientY; draw();
}});
canvas.onwheel = e => {{
  dist *= Math.exp(e.deltaY * 0.001); draw(); e.preventDefault();
}};
function project(p) {{
  const x0 = p[0] - center[0], y0 = p[1] - center[1], z0 = p[2] - center[2];
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x1 = cy * x0 + sy * z0, z1 = -sy * x0 + cy * z0;
  const y2 = cp * y0 - sp * z1, z2 = sp * y0 + cp * z1;
  const zc = z2 + dist;
  if (zc <= 0.05) return null;
  const f = 0.9 * Math.min(canvas.width, canvas.height);
  return [canvas.width / 2 + f * x1 / zc + panX,
          canvas.height / 2 + f * y2 / zc + panY, zc];
}}
addEventListener('keydown', e => {{
  if (e.key === 'r') {{ spinning = !spinning; if (spinning) orbit(); }}
}});
function orbit() {{
  if (!spinning) return;
  yaw += 0.01; draw();
  requestAnimationFrame(orbit);
}}
function draw() {{
  ctx.fillStyle = '{background}';
  ctx.fillRect(0, 0, canvas.width, canvas.height);
  for (let i = 0; i < PTS.length; i++) {{
    const s = project(PTS[i]);
    if (!s) continue;
    ctx.fillStyle = COL[i];
    const r = Math.max(1, PS / Math.sqrt(s[2]));
    ctx.fillRect(s[0], s[1], r, r);
  }}
  for (let ci = 0; ci < CAMS.length; ci++) {{
    const cam = CAMS[ci];
    ctx.strokeStyle = ci === selCam ? '#ff0' : '#e33';
    const apex = project(cam[0]);
    if (!apex) continue;
    for (let k = 1; k < 5; k++) {{
      const c = project(cam[k]);
      if (!c) continue;
      ctx.beginPath(); ctx.moveTo(apex[0], apex[1]);
      ctx.lineTo(c[0], c[1]); ctx.stroke();
    }}
    for (let k = 1; k < 5; k++) {{
      const a = project(cam[k]), b = project(cam[k % 4 + 1]);
      if (!a || !b) continue;
      ctx.beginPath(); ctx.moveTo(a[0], a[1]);
      ctx.lineTo(b[0], b[1]); ctx.stroke();
    }}
  }}
}}
resize();
if (spinning) orbit();
{live_script}</script></body></html>
"""


def _viewer_payload(reconstruction, max_points=50_000, frustum_scale=0.3,
                    color_mode="rgb"):
    """Point/camera payload shared by the static export, the live
    (auto-refreshing) viewer state, and tests."""
    from sba_tpu_torch.sfm.incremental_triangulator import _projection_center, \
        _rotmat

    pts = []
    cols = []
    pids = []
    for pid, p in reconstruction.points3D.items():
        pts.append(p.xyz)
        pids.append(int(pid))
        c = np.asarray(p.rgb, float)
        if c.max() <= 0:
            c = np.array([200.0, 200.0, 200.0])
        cols.append(f"rgb({int(c[0])},{int(c[1])},{int(c[2])})")
    pts = np.asarray(pts).reshape(-1, 3)
    if color_mode == "uniform":
        cols = ["rgb(220,220,220)"] * len(pts)
    elif color_mode == "height" and len(pts):
        z = pts[:, 2]
        lo, hi = np.percentile(z, 5), np.percentile(z, 95)
        t = np.clip((z - lo) / max(hi - lo, 1e-9), 0, 1)
        cols = [f"rgb({int(60 + 180 * ti)},{int(80 + 120 * (1 - abs(ti - 0.5) * 2))},{int(240 - 180 * ti)})"
                for ti in t]
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts = pts[sel]
        cols = [cols[i] for i in sel]
        pids = [pids[i] for i in sel]

    cams = []
    cam_names = []
    for iid in reconstruction.images:
        if not reconstruction.is_registered(iid):
            continue
        img = reconstruction.images[iid]
        C = _projection_center(img.qvec, img.tvec)
        R = _rotmat(img.qvec)
        s = frustum_scale
        corners = [C + R.T @ np.array([sx * s, sy * s, 2 * s])
                   for (sx, sy) in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
        cams.append([C.tolist()] + [c.tolist() for c in corners])
        cam_names.append(getattr(img, "name", str(iid)) or str(iid))

    if len(pts):
        center = pts.mean(0)
        spread = float(np.percentile(
            np.linalg.norm(pts - center, axis=1), 90)) * 2.5 + 1e-6
    else:
        center = np.zeros(3)
        spread = 10.0
    return dict(
        points=np.round(pts, 4).tolist(), colors=cols, point_ids=pids,
        cameras=cams, camera_names=cam_names,
        center=[round(float(v), 4) for v in center],
        initial_dist=round(spread, 3))


def export_html_viewer(reconstruction, path: str,
                       max_points: int = 50_000,
                       frustum_scale: float = 0.3,
                       title: str = "sba_tpu reconstruction",
                       point_size: float = 3.0,
                       background: str = "#111",
                       color_mode: str = "rgb",
                       animate: bool = False):
    """Write a single-file interactive viewer for a reconstruction.

    Render options mirror the reference GUI's render-options dialog
    (ref: src/ui render options — point size, background, coloring) and
    `animate` starts the orbit fly-through (movie-grabber capability:
    press 'r' in the viewer to toggle; record with any screen recorder).
    color_mode: rgb (track colors) | height (z colormap) | uniform."""
    pay = _viewer_payload(reconstruction, max_points, frustum_scale,
                          color_mode)
    html = _TEMPLATE.format(
        title=title,
        num_points=len(pay["points"]),
        num_cameras=len(pay["cameras"]),
        points_json=json.dumps(pay["points"]),
        colors_json=json.dumps(pay["colors"]),
        point_ids_json=json.dumps(pay["point_ids"]),
        cameras_json=json.dumps(pay["cameras"]),
        camera_names_json=json.dumps(pay["camera_names"]),
        center_json=json.dumps(pay["center"]),
        initial_dist=pay["initial_dist"],
        point_size=point_size,
        background=background,
        animate_json="true" if animate else "false",
        live_script="",
    )
    with open(path, "w") as f:
        f.write(html)
    return path


_LIVE_SCRIPT = """
let livePrev = -1;
async function poll() {
  try {
    const r = await fetch('state.json?t=' + Date.now());
    const s = await r.json();
    if (s.revision !== livePrev) {
      livePrev = s.revision;
      PTS = s.points; COL = s.colors; IDS = s.point_ids;
      CAMS = s.cameras; CAM_NAMES = s.camera_names; center = s.center;
      document.getElementById('hud').childNodes[0].textContent =
        'live mapping - ' + PTS.length + ' points, ' + CAMS.length +
        ' cameras (rev ' + s.revision + ')';
      draw();
    }
  } catch (e) {}
  setTimeout(poll, 1000);
}
poll();
"""


def export_viewer_state(reconstruction, dir_path: str, revision: int,
                        max_points: int = 50_000):
    """Write `state.json` for the live viewer (one call per mapper
    snapshot; the page polls and re-renders on revision change).
    The counterpart of the reference GUI's live display of the model
    growing during mapping (ref: src/ui/main_window.h:61
    RenderNow/RenderSelectedReconstruction)."""
    import os

    pay = _viewer_payload(reconstruction, max_points=max_points)
    pay["revision"] = int(revision)
    pay["num_registered"] = int(
        sum(1 for i in reconstruction.images
            if reconstruction.is_registered(i)))
    tmp = os.path.join(dir_path, ".state.json.tmp")
    with open(tmp, "w") as f:
        json.dump(pay, f)
    os.replace(tmp, os.path.join(dir_path, "state.json"))


def export_live_viewer(dir_path: str):
    """Write `live.html` into `dir_path`: the standard viewer page with
    a 1 Hz poll of `state.json` (written per snapshot by the mapper).
    Serve the directory (`model_viewer --follow <dir>`) and open
    live.html to watch the reconstruction grow."""
    import os

    html = _TEMPLATE.format(
        title="live mapping", num_points=0, num_cameras=0,
        points_json="[]", colors_json="[]", point_ids_json="[]",
        cameras_json="[]", camera_names_json="[]",
        center_json="[0,0,0]", initial_dist=10.0, point_size=3.0,
        background="#111", animate_json="false",
        live_script=_LIVE_SCRIPT,
    )
    path = os.path.join(dir_path, "live.html")
    with open(path, "w") as f:
        f.write(html)
    return path
