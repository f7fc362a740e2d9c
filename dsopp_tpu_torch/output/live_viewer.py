"""Live 3D track viewer over HTTP (counterpart of
``dsopp_tpu/output/live_viewer.py``): the reference Visualizer's role
(semi-dense cloud, keyframe frusta, trajectory, landmark-class toggles,
camera follow), served to a browser, since the card's machine has no
display.  A :class:`LiveViewer` is a track observer that keeps a snapshot of
the track, and a threaded HTTP server on 127.0.0.1 exposes

* ``/``           — a self-contained HTML page (no external assets): the
                    point cloud, trajectory and keyframe frusta drawn on a
                    ``<canvas>``, mouse orbit and zoom, the toggles, an FPS
                    and status line;
* ``/state.json`` — the current snapshot (polled by the page).

The snapshot holds host data only: the observer hooks get host copies
(marginalized keyframes are numpy; ``finish`` copies the window's poses to
the host on the caller's thread), and the HTTP thread reads nothing but
those lists, under a lock.

Usage::

    viewer = LiveViewer(camera_model, port=8642)
    app.run(observers=[viewer])          # or tracker.track.observers.append
    # browse http://localhost:8642/ while tracking; viewer.close() when done
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>dsopp_tpu_torch live</title><style>
 body{margin:0;background:#101218;color:#cfd4e0;font:12px monospace;overflow:hidden}
 #hud{position:absolute;left:8px;top:8px;line-height:1.5}
 #hud label{margin-right:10px;cursor:pointer}
 canvas{display:block}
</style></head><body>
<div id="hud">
  <div id="status">waiting for data…</div>
  <label><input type="checkbox" id="marg" checked>marginalized cloud</label>
  <label><input type="checkbox" id="act" checked>active landmarks</label>
  <label><input type="checkbox" id="fru" checked>frusta</label>
  <label><input type="checkbox" id="follow">follow camera</label>
</div>
<canvas id="c"></canvas>
<script>
const cv=document.getElementById('c'),cx2=cv.getContext('2d');
let S=null,yaw=-0.6,pitch=-0.5,dist=8,cen=[0,0,2],drag=null;
function resize(){cv.width=innerWidth;cv.height=innerHeight;}addEventListener('resize',resize);resize();
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
cv.onmouseup=()=>drag=null;
cv.onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-drag[0])*0.01;pitch+=(e.clientY-drag[1])*0.01;
 pitch=Math.max(-1.5,Math.min(1.5,pitch));drag=[e.clientX,e.clientY];};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
function cam(){const cp=Math.cos(pitch),sp=Math.sin(pitch),cy=Math.cos(yaw),sy=Math.sin(yaw);
 const f=[cp*sy,sp,cp*cy];const eye=[cen[0]-f[0]*dist,cen[1]-f[1]*dist,cen[2]-f[2]*dist];
 const up=[0,-1,0];
 const z=f;let x=[up[1]*z[2]-up[2]*z[1],up[2]*z[0]-up[0]*z[2],up[0]*z[1]-up[1]*z[0]];
 const xl=Math.hypot(...x);x=x.map(v=>v/xl);
 const y=[z[1]*x[2]-z[2]*x[1],z[2]*x[0]-z[0]*x[2],z[0]*x[1]-z[1]*x[0]];
 return {eye,x,y,z};}
function proj(p,C){const d=[p[0]-C.eye[0],p[1]-C.eye[1],p[2]-C.eye[2]];
 const zc=d[0]*C.z[0]+d[1]*C.z[1]+d[2]*C.z[2];if(zc<0.05)return null;
 const xc=d[0]*C.x[0]+d[1]*C.x[1]+d[2]*C.x[2],yc=d[0]*C.y[0]+d[1]*C.y[1]+d[2]*C.y[2];
 const f=0.9*Math.min(cv.width,cv.height);
 return [cv.width/2+f*xc/zc,cv.height/2+f*yc/zc,zc];}
function jet(t){t=Math.max(0,Math.min(1,t));
 const r=Math.min(1,Math.max(0,1.5-Math.abs(4*t-3)));
 const g=Math.min(1,Math.max(0,1.5-Math.abs(4*t-2)));
 const b=Math.min(1,Math.max(0,1.5-Math.abs(4*t-1)));
 return `rgb(${r*255|0},${g*255|0},${b*255|0})`;}
function draw(){requestAnimationFrame(draw);cx2.fillStyle='#101218';
 cx2.fillRect(0,0,cv.width,cv.height);if(!S)return;const C=cam();
 if(document.getElementById('marg').checked&&S.points){
  for(let i=0;i<S.points.length;i+=4){const q=proj(S.points.slice(i,i+3),C);
   if(q){cx2.fillStyle=jet(S.points[i+3]);cx2.fillRect(q[0],q[1],1.6,1.6);}}}
 if(document.getElementById('act').checked&&S.active){
  cx2.fillStyle='#ffd24a';
  for(let i=0;i<S.active.length;i+=3){const q=proj(S.active.slice(i,i+3),C);
   if(q)cx2.fillRect(q[0],q[1],2,2);}}
 if(S.traj&&S.traj.length>=6){cx2.strokeStyle='#59d98e';cx2.beginPath();let m=false;
  for(let i=0;i<S.traj.length;i+=3){const q=proj(S.traj.slice(i,i+3),C);
   if(q){m?cx2.lineTo(q[0],q[1]):cx2.moveTo(q[0],q[1]);m=true;}else m=false;}
  cx2.stroke();}
 if(document.getElementById('fru').checked&&S.frusta){cx2.strokeStyle='#6ab0ff';
  for(const fr of S.frusta){const ps=[];for(let i=0;i<15;i+=3)ps.push(proj(fr.slice(i,i+3),C));
   const e=[[0,1],[0,2],[0,3],[0,4],[1,2],[2,3],[3,4],[4,1]];
   cx2.beginPath();for(const [a,b] of e){if(ps[a]&&ps[b]){cx2.moveTo(ps[a][0],ps[a][1]);
    cx2.lineTo(ps[b][0],ps[b][1]);}}cx2.stroke();}}
}
draw();
async function poll(){try{const r=await fetch('state.json');S=await r.json();
  document.getElementById('status').textContent=
   `frame ${S.frame_id}  keyframes ${S.num_keyframes}  cloud ${S.points.length/4|0}  fps ${S.fps.toFixed(1)}`;
  if(document.getElementById('follow').checked&&S.traj.length>=3)
   cen=S.traj.slice(S.traj.length-3);
 }catch(e){}finally{setTimeout(poll,500);}}
poll();
</script></body></html>"""


class LiveViewer:
    """Track observer serving the live 3D view over HTTP (see module doc).

    ``camera``: pinhole-like model with fx/fy/cx/cy (landmark directions
    are recovered as the reference stores them: unproject(uv), z = 1).
    ``port=0`` picks a free port (``viewer.port`` reports it).
    """

    MAX_POINTS = 200_000   # rolling cloud cap (oldest dropped first)

    def __init__(self, camera=None, port: int = 0, host: str = "127.0.0.1"):
        self.camera = camera
        self._lock = threading.Lock()
        self._points: list = []       # [x, y, z, idepth-color] quads
        self._traj: list = []
        self._frusta: list = []
        self._frame_id = -1
        self._num_kf = 0
        self._times: list = []
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # silence request logging
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    ctype = "text/html; charset=utf-8"
                elif self.path.startswith("/state.json"):
                    body = viewer._state_json().encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    # ---- observer hooks --------------------------------------------------
    def on_frame(self, frame, result) -> None:
        import time

        with self._lock:
            self._frame_id = getattr(frame, "frame_id", self._frame_id)
            self._times.append(time.time())
            self._times = self._times[-50:]

    def on_keyframe(self, frame_id: int, timestamp: float) -> None:
        with self._lock:
            self._num_kf += 1

    def on_marginalize(self, kf) -> None:
        """Fold a dropped keyframe's landmarks into the persistent cloud and
        its pose into the trajectory/frusta (the reference pushes
        marginalized frames into the static view the same way)."""
        t_wc = np.asarray(kf.t_wc, np.float64)
        pts = self._world_points(kf)
        with self._lock:
            self._traj.extend(t_wc[:3, 3].tolist())
            self._frusta.append(self._frustum(t_wc))
            self._points.extend(pts)
            overflow = len(self._points) - 4 * self.MAX_POINTS
            if overflow > 0:
                del self._points[:overflow]

    def finish(self, tracker) -> None:
        """The window's keyframes as frusta (the run's last state stays up):
        their poses copied to the host here, on the caller's thread."""
        window = tracker.window
        poses = window.poses().matrix().cpu().numpy().astype(np.float64)
        valid = window.frame_valid.cpu().numpy()
        with self._lock:
            for pos in np.where(valid)[0]:
                self._frusta.append(self._frustum(poses[pos]))

    # ---- geometry --------------------------------------------------------
    def _world_points(self, kf) -> list:
        uv = np.asarray(kf.lm_uv, np.float64)
        idep = np.asarray(kf.lm_idepth, np.float64)
        live = np.asarray(kf.lm_valid) & ~np.asarray(kf.lm_outlier) & (idep > 1e-9)
        if not live.any() or self.camera is None:
            return []
        uv, idep = uv[live], idep[live]
        fx = float(np.asarray(self.camera.fx))
        fy = float(np.asarray(self.camera.fy))
        cx = float(np.asarray(self.camera.cx))
        cy = float(np.asarray(self.camera.cy))
        d = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                      np.ones(len(uv))], axis=1)
        p_c = d / idep[:, None]
        t_wc = np.asarray(kf.t_wc, np.float64)
        p_w = p_c @ t_wc[:3, :3].T + t_wc[:3, 3]
        color = np.clip(idep / max(np.percentile(idep, 90), 1e-9), 0, 1)
        return np.concatenate([p_w, color[:, None]], axis=1).ravel().tolist()

    @staticmethod
    def _frustum(t_wc, scale: float = 0.25) -> list:
        corners = np.array([
            [0.0, 0.0, 0.0],
            [-0.5, -0.375, 1.0], [0.5, -0.375, 1.0],
            [0.5, 0.375, 1.0], [-0.5, 0.375, 1.0],
        ]) * scale
        w = corners @ t_wc[:3, :3].T + t_wc[:3, 3]
        return w.ravel().tolist()

    # ---- server ----------------------------------------------------------
    def _state_json(self) -> str:
        with self._lock:
            if len(self._times) >= 2:
                fps = (len(self._times) - 1) / max(
                    self._times[-1] - self._times[0], 1e-9)
            else:
                fps = 0.0
            return json.dumps({
                "frame_id": self._frame_id,
                "num_keyframes": self._num_kf,
                "fps": fps,
                "points": self._points,
                "active": [],
                "traj": self._traj,
                "frusta": self._frusta,
            })

    def close(self):
        self._server.shutdown()
        self._server.server_close()
