"""Headless views of a run (counterpart of the JAX package's viewer.py):
the same files, the same JSON keys and the same HTTP controls.

  * `render_snapshot`: a top-down PNG of map points, trajectory and
    keyframes (matplotlib, imported when called; without it the call
    returns False and draws nothing);
  * `ConsoleViewer`: the auto and step frame-loop controls as a console
    progress line (step mode waits for Enter);
  * `export_state`: the map (map.ply), the trajectory and keyframe
    positions (CSV), the L1 surfels (centroid, normal, planarity) and the
    last per-frame-path frame's cloud at its pre-ICP guess and at its ICP
    pose, for external viewers;
  * `LiveViewer`: a local HTTP server with a self-contained canvas page,
    /state.json (the latest snapshot, downsampled) and /control
    (auto/step/finish for the player's frame loop).

The map is read through ops/voxel_map's l0_points and l1_surfels; the
device tensors an update needs are fetched to the host once per update.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from .models.estimator import _host
from .ops import voxel_map as vm
from .utils import logging_util as log

__all__ = ["render_snapshot", "ConsoleViewer", "export_state", "LiveViewer"]


def render_snapshot(path: str, map_points: Optional[np.ndarray] = None,
                    trajectory: Optional[np.ndarray] = None,
                    keyframe_positions: Optional[np.ndarray] = None,
                    title: str = "lidar_odometry_tpu_torch") -> bool:
    """Top-down (x, y) snapshot PNG. Returns False, and writes nothing,
    where matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        log.warn("[viewer] matplotlib unavailable; snapshot skipped")
        return False
    fig, ax = plt.subplots(figsize=(10, 10))
    if map_points is not None and len(map_points):
        ax.scatter(map_points[:, 0], map_points[:, 1], s=0.3, c=map_points[:, 2],
                   cmap="viridis", alpha=0.5, linewidths=0)
    if trajectory is not None and len(trajectory):
        xy = trajectory[:, :2, 3] if trajectory.ndim == 3 else trajectory[:, :2]
        ax.plot(xy[:, 0], xy[:, 1], "r-", linewidth=1.5, label="trajectory")
    if keyframe_positions is not None and len(keyframe_positions):
        ax.scatter(keyframe_positions[:, 0], keyframe_positions[:, 1],
                   s=18, c="k", marker="^", label="keyframes")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title)
    ax.legend(loc="upper right")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    log.info("[viewer] snapshot saved: {}", path)
    return True


class ConsoleViewer:
    """Auto and step modes of the frame loop as a console progress line."""

    def __init__(self, step_mode: bool = False, print_every: int = 20):
        self.step_mode = step_mode
        self.print_every = print_every
        self._frame = 0

    def on_frame(self, pose: np.ndarray, n_points: int = 0, n_keyframes: int = 0) -> bool:
        """Called once per processed frame; returns False to stop."""
        self._frame += 1
        if self._frame % self.print_every == 0 or self.step_mode:
            t = pose[:3, 3]
            sys.stderr.write(
                f"\r[frame {self._frame:5d}] pos=({t[0]:8.2f},{t[1]:8.2f},"
                f"{t[2]:6.2f}) pts={n_points:6d} kf={n_keyframes:4d}  ")
            sys.stderr.flush()
        if self.step_mode:
            try:
                if input("  [step] Enter=next, q=quit: ").strip().lower() == "q":
                    return False
            except EOFError:
                self.step_mode = False
        return True

    def finish(self):
        sys.stderr.write("\n")


def _surfel_rows(state) -> np.ndarray:
    """(S, 7) [centroid | normal | planarity] of the valid L1 surfels, in
    one fetch."""
    normals, centroids, planarity, valid = vm.l1_surfels(state)
    rows = _host(torch.cat([centroids, normals, planarity[:, None],
                            valid[:, None].to(planarity.dtype)], 1))
    return rows[rows[:, 7] > 0.0, :7]


def _keyframe_positions(estimator) -> np.ndarray:
    with estimator._keyframes_lock:
        kfs = list(estimator.keyframes)
    return (np.stack([k.stored_pose[:3, 3] for k in kfs]) if kfs
            else np.zeros((0, 3), np.float32))


def _last_frame_clouds(estimator):
    """The last per-frame-path frame's live features in homogeneous
    coordinates (n, 4) and its pre-ICP guess, or (None, None)."""
    feat = getattr(estimator, "_last_feat", None)
    if feat is None:
        return None, None
    pts = _host(feat)[_host(estimator._last_mask).astype(bool)]
    h = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1)
    guess = getattr(estimator, "_last_icp_guess", None)
    return h, (None if guess is None else _host(guess))


def export_state(out_dir: str, estimator) -> None:
    """map.ply, trajectory_xyz.csv, keyframes_xyz.csv, surfels.csv, the
    last frame's debug_pre_icp.ply and debug_post_icp.ply (where it ran
    the per-frame path) and snapshot.png (where matplotlib is
    installed)."""
    from .io.ply import save_ply
    os.makedirs(out_dir, exist_ok=True)
    mp = estimator.map_points()
    save_ply(os.path.join(out_dir, "map.ply"), mp)
    traj = estimator.trajectory()
    np.savetxt(os.path.join(out_dir, "trajectory_xyz.csv"), traj[:, :3, 3], delimiter=",",
               header="x,y,z")
    kf_pos = _keyframe_positions(estimator)
    np.savetxt(os.path.join(out_dir, "keyframes_xyz.csv"), kf_pos, delimiter=",")
    np.savetxt(os.path.join(out_dir, "surfels.csv"), _surfel_rows(estimator.map_state),
               delimiter=",", header="cx,cy,cz,nx,ny,nz,planarity")
    h, guess = _last_frame_clouds(estimator)
    if h is not None and guess is not None:
        save_ply(os.path.join(out_dir, "debug_pre_icp.ply"), (h @ guess.T)[:, :3])
        save_ply(os.path.join(out_dir, "debug_post_icp.ply"), (h @ estimator.T_current.T)[:, :3])
    render_snapshot(os.path.join(out_dir, "snapshot.png"), map_points=mp, trajectory=traj,
                    keyframe_positions=kf_pos)


_LIVE_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>lidar_odometry_tpu_torch live</title>
<style>
 body{margin:0;background:#101014;color:#ddd;font:13px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:8px 10px;border-radius:6px}
 button{font:12px monospace;margin-right:6px;background:#2a2a33;color:#ddd;
        border:1px solid #555;border-radius:4px;padding:3px 10px;cursor:pointer}
 button:hover{background:#3a3a46}
 #help{position:fixed;bottom:8px;left:8px;color:#888}
</style></head><body>
<canvas id="cv"></canvas>
<div id="hud">
 <div id="stats">connecting...</div>
 <div style="margin-top:6px">
  <button onclick="ctl('auto')">auto</button>
  <button onclick="ctl('step')">step</button>
  <button onclick="ctl('finish')">finish</button>
 </div>
 <div style="margin-top:6px">
  <label><input type="checkbox" checked onchange="tgl('map',this)">map</label>
  <label><input type="checkbox" checked onchange="tgl('scan',this)">scan</label>
  <label><input type="checkbox" checked onchange="tgl('kf',this)">kf</label>
  <label><input type="checkbox" onchange="tgl('surfels',this)">surfels</label>
  <label><input type="checkbox" onchange="tgl('debug',this)">icp-debug</label>
 </div>
</div>
<div id="help">drag: orbit &middot; wheel: zoom &middot; shift-drag: pan</div>
<script>
const cv=document.getElementById('cv'),cx=cv.getContext('2d');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;}rs();
addEventListener('resize',rs);
let yaw=-0.7,pitch=0.9,dist=120,panx=0,pany=0,drag=0,px=0,py=0;
cv.onmousedown=e=>{drag=e.shiftKey?2:1;px=e.clientX;py=e.clientY};
addEventListener('mouseup',()=>drag=0);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-px,dy=e.clientY-py;px=e.clientX;py=e.clientY;
 if(drag==1){yaw+=dx*0.008;pitch=Math.max(0.05,Math.min(1.55,pitch+dy*0.008));}
 else{panx-=dx*dist*0.002;pany+=dy*dist*0.002;}});
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
let S=null;
const show={map:1,scan:1,kf:1,traj:1,surfels:0,debug:0};
function tgl(k,el){show[k]=el.checked?1:0;}
function proj(p){
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 let x=p[0]-panx,y=p[1]-pany,z=p[2];
 let u=cy*x+sy*y, v=-sy*x+cy*y;
 let w=cp*v+sp*z, d=-sp*v+cp*z+dist;
 if(d<0.5)return null;
 const f=0.9*Math.min(W,H)/d;
 return [W/2+u*f, H/2-w*f, f];
}
function dots(pts,col,r){cx.fillStyle=col;
 for(const p of pts){const q=proj(p);if(!q)continue;
  cx.fillRect(q[0]-r,q[1]-r,2*r,2*r);}}
function line(pts,col){cx.strokeStyle=col;cx.lineWidth=1.6;cx.beginPath();
 let first=1;for(const p of pts){const q=proj(p);if(!q){first=1;continue;}
  if(first){cx.moveTo(q[0],q[1]);first=0;}else cx.lineTo(q[0],q[1]);}
 cx.stroke();}
function surfels(ss){ // [cx,cy,cz,nx,ny,nz,plan] discs + normal ticks
 for(const s of ss){const q=proj(s);if(!q)continue;
  const g=Math.max(0,1-s[6]*8);  // greener = more planar
  cx.strokeStyle=`rgba(${140-g*80|0},${160+g*60|0},120,0.8)`;
  const r=Math.min(9,0.45*q[2]);
  cx.beginPath();cx.arc(q[0],q[1],Math.max(1.5,r),0,6.3);cx.stroke();
  const t=proj([s[0]+s[3]*0.6,s[1]+s[4]*0.6,s[2]+s[5]*0.6]);
  if(t){cx.beginPath();cx.moveTo(q[0],q[1]);cx.lineTo(t[0],t[1]);cx.stroke();}}}
function draw(){cx.fillStyle='#101014';cx.fillRect(0,0,W,H);
 if(S){
  if(S.map&&show.map)dots(S.map,'#4f7f9f',1);
  if(S.surfels&&show.surfels)surfels(S.surfels);
  if(S.pre_icp&&show.debug)dots(S.pre_icp,'#cc5fd0',1);
  if(S.post_icp&&show.debug)dots(S.post_icp,'#5fd0cc',1);
  if(S.scan&&show.scan)dots(S.scan,'#d8d44f',1);
  if(S.kf&&show.kf)dots(S.kf,'#ffffff',2);
  if(S.traj&&show.traj)line(S.traj,'#ef5350');
  if(S.traj&&S.traj.length){const q=proj(S.traj[S.traj.length-1]);
   if(q){cx.strokeStyle='#ef5350';cx.beginPath();
    cx.arc(q[0],q[1],6,0,6.3);cx.stroke();}}
 }
 requestAnimationFrame(draw);}
draw();
async function poll(){try{
  const r=await fetch('state.json');S=await r.json();
  document.getElementById('stats').textContent=
   `frame ${S.frame}  kf ${S.n_kf}  map ${S.n_map}  loops ${S.loops}  mode ${S.mode}`;
 }catch(e){}
 setTimeout(poll,500);}
poll();
function ctl(m){fetch('control?mode='+m,{method:'POST'});}
</script></body></html>"""


def _every(a: np.ndarray, most: int) -> np.ndarray:
    return a[:: len(a) // most + 1] if len(a) > most else a


class LiveViewer:
    """A live view of a run as a local HTTP server (127.0.0.1) with a
    self-contained canvas renderer, reachable over an SSH port-forward:

      /            the 3D view (orbit, zoom, pan; trajectory, map points,
                   current scan, keyframes, surfels, ICP debug clouds)
      /state.json  the latest snapshot (downsampled)
      /control     POST ?mode=auto|step|finish: the player's frame loop

    `update(est)` snapshots the estimator's state on the caller's thread;
    the server thread only reads the latest snapshot. port=0 takes a free
    port (see .port)."""

    def __init__(self, port: int = 8123, max_map_points: int = 60000,
                 max_scan_points: int = 20000, max_surfels: int = 15000,
                 step_mode: bool = False):
        import http.server

        self.max_map = max_map_points
        self.max_scan = max_scan_points
        self.max_surfels = max_surfels
        self._lock = threading.Lock()
        self._state_bytes = b"{}"
        self._mode = "step" if step_mode else "auto"
        self._pending_steps = 0
        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/state.json"):
                    with viewer._lock:
                        body = viewer._state_bytes
                    self._send(200, body, "application/json")
                else:
                    self._send(200, _LIVE_HTML.encode(), "text/html")

            def do_POST(self):
                if self.path.startswith("/control"):
                    mode = self.path.split("mode=")[-1]
                    with viewer._lock:
                        if mode == "step":
                            viewer._mode = "step"
                            viewer._pending_steps += 1
                        elif mode in ("auto", "finish"):
                            viewer._mode = mode
                    self._send(200, b"ok", "text/plain")
                else:
                    self._send(404, b"", "text/plain")

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        log.info("[viewer] live viewer at http://127.0.0.1:{}/", self.port)

    def update(self, estimator) -> None:
        """Snapshot the estimator's state for the server thread."""
        traj = estimator.trajectory()
        kf = _keyframe_positions(estimator)
        mp = estimator.map_points()
        n_map = len(mp)          # the map's size before the downsampling
        mp = _every(mp, self.max_map)
        scan = np.zeros((0, 3), np.float32)
        pre = post = None
        h, guess = _last_frame_clouds(estimator)
        if h is not None:
            scan = (h @ estimator.T_current.T)[:, :3]
            if guess is not None:
                pre, post = _every((h @ guess.T)[:, :3], self.max_scan), _every(scan, self.max_scan)
            scan = _every(scan, self.max_scan)
        surf = _every(_surfel_rows(estimator.map_state), self.max_surfels)
        state = {
            "frame": int(estimator.frame_count),
            "n_kf": int(len(kf)),
            "n_map": int(n_map),
            "loops": int(estimator.loop_constraint_count),
            "mode": self.mode,
            "traj": np.round(traj[:, :3, 3], 3).tolist(),
            "kf": np.round(kf, 3).tolist(),
            "map": np.round(mp, 3).tolist(),
            "scan": np.round(scan, 3).tolist(),
            "surfels": np.round(surf, 3).tolist(),
        }
        if pre is not None:
            state["pre_icp"] = np.round(pre, 3).tolist()
            state["post_icp"] = np.round(post, 3).tolist()
        body = json.dumps(state).encode()
        with self._lock:
            self._state_bytes = body

    @property
    def mode(self) -> str:
        """The control mode: auto, step or finish."""
        with self._lock:
            return self._mode

    def wait_if_stepping(self, poll_s: float = 0.05) -> bool:
        """The frame loop's gate: False once finish was pressed; in step
        mode it blocks until a step is granted."""
        while True:
            with self._lock:
                if self._mode == "finish":
                    return False
                if self._mode == "auto":
                    return True
                if self._pending_steps > 0:
                    self._pending_steps -= 1
                    return True
            time.sleep(poll_s)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
