"""Interactive live 3-D map viewer over HTTP.

Counterpart of plvs_tpu/viz/live_server.py (the reference's Pangolin
window, src/Viewer.cc:305-393, and its dense drawing,
src/PointCloudDrawer.cc + Shaders/): a stdlib HTTP server streams JSON
snapshots of the sparse map (points, line landmarks, keyframes and
covisibility edges, trajectory, the current camera's frustum) and
decimated dense-mesh triangles to one self-contained WebGL page (no
external script), and takes the same control verbs (pause, resume, map
save, localization / mapping). Where it differs from the JAX viewer:

* ``state()`` reads the store, the covisibility edges included, under the
  store's lock (an ``RLock``, the one the tracker and the backend take);
* ``mesh_state()`` meshes through ``DenseMapper.mesh_incremental``, which
  holds the mapper's own lock, so the HTTP thread never races the
  tracking or mapper thread's integration and meshing over the mesher's
  dirty-slot state;
* no exception is caught around device work: the JAX viewer turns any
  failure of ``state()``, ``mesh_state()`` or ``save`` into an empty
  view, the port returns the empty mesh payload only where JAX defines
  one (no dense mapper, or no face yet). A failed ``save`` write
  (``OSError``) is answered with HTTP 500 and the error's text.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..io import serialization
from .map_drawer import covisibility_segments

_PAGE = """<!DOCTYPE html>
<html><head><title>plvs_tpu_torch live</title><style>
body{margin:0;background:#111;color:#ddd;font:13px monospace;overflow:hidden}
#bar{padding:6px;position:fixed;top:0;left:0;right:0;background:#111a;z-index:2}
#bar button{margin-right:6px}
canvas{display:block;position:fixed;top:0;left:0}
#help{position:fixed;bottom:4px;left:6px;color:#666;z-index:2}
</style></head><body>
<div id="bar">
 <button onclick="cmd('pause')">pause</button>
 <button onclick="cmd('resume')">resume</button>
 <button onclick="cmd('save')">save map</button>
 <label><input id="follow" type="checkbox" checked>follow</label>
 <label><input id="mesh" type="checkbox" checked>mesh</label>
 <span id="stat"></span>
</div>
<div id="help">drag: orbit &nbsp; shift/right-drag: pan &nbsp; wheel: zoom
 &nbsp; '2': top-down &nbsp; '3': orbit</div>
<canvas id="c"></canvas>
<script>
'use strict';
const c=document.getElementById('c');
const gl=c.getContext('webgl',{antialias:true});
function rs(){c.width=innerWidth;c.height=innerHeight;
 gl&&gl.viewport(0,0,c.width,c.height)}rs();onresize=rs;
// ---- minimal mat4 ----
function ident(){return[1,0,0,0,0,1,0,0,0,0,1,0,0,0,0,1]}
function mul(a,b){const o=new Array(16);for(let i=0;i<4;i++)for(let j=0;j<4;j++){
 let s=0;for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];o[i*4+j]=s}return o}
function persp(f,asp,n,fa){const t=1/Math.tan(f/2);return[
 t/asp,0,0,0, 0,t,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0]}
function lookAt(e,ctr,up){
 let z=[e[0]-ctr[0],e[1]-ctr[1],e[2]-ctr[2]];
 let zl=Math.hypot(...z);z=z.map(v=>v/zl);
 let x0=[up[1]*z[2]-up[2]*z[1],up[2]*z[0]-up[0]*z[2],up[0]*z[1]-up[1]*z[0]];
 let xl=Math.hypot(...x0);x0=x0.map(v=>v/xl);
 const y=[z[1]*x0[2]-z[2]*x0[1],z[2]*x0[0]-z[0]*x0[2],z[0]*x0[1]-z[1]*x0[0]];
 return[x0[0],y[0],z[0],0, x0[1],y[1],z[1],0, x0[2],y[2],z[2],0,
  -(x0[0]*e[0]+x0[1]*e[1]+x0[2]*e[2]),
  -(y[0]*e[0]+y[1]*e[1]+y[2]*e[2]),
  -(z[0]*e[0]+z[1]*e[1]+z[2]*e[2]),1]}
// ---- shaders ----
const VS=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
uniform float ps;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=ps;vc=col;}`;
const FS=`precision mediump float;varying vec3 vc;uniform float alpha;
void main(){gl_FragColor=vec4(vc,alpha);}`;
function shader(src,t){const s=gl.createShader(t);gl.shaderSource(s,src);
 gl.compileShader(s);return s}
const prog=gl.createProgram();
gl.attachShader(prog,shader(VS,gl.VERTEX_SHADER));
gl.attachShader(prog,shader(FS,gl.FRAGMENT_SHADER));
gl.linkProgram(prog);gl.useProgram(prog);
const locP=gl.getAttribLocation(prog,'p'),
      locC=gl.getAttribLocation(prog,'col'),
      locM=gl.getUniformLocation(prog,'mvp'),
      locS=gl.getUniformLocation(prog,'ps'),
      locA=gl.getUniformLocation(prog,'alpha');
gl.enable(gl.DEPTH_TEST);
function buf(data){const b=gl.createBuffer();
 gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(data),gl.DYNAMIC_DRAW);
 return {b:b,n:data.length/6}}
function draw(o,mode,ps,alpha){if(!o||!o.n)return;
 gl.bindBuffer(gl.ARRAY_BUFFER,o.b);
 gl.enableVertexAttribArray(locP);gl.enableVertexAttribArray(locC);
 gl.vertexAttribPointer(locP,3,gl.FLOAT,false,24,0);
 gl.vertexAttribPointer(locC,3,gl.FLOAT,false,24,12);
 gl.uniform1f(locS,ps||2.0);gl.uniform1f(locA,alpha==null?1.0:alpha);
 gl.drawArrays(mode,0,o.n)}
// ---- scene buffers ----
let bPts=null,bLines=null,bTraj=null,bKf=null,bCovis=null,bFrus=null,
    bMesh=null,bMeshW=null;
// orbit camera (y-down world: keep y inverted in view)
let yaw=-0.6,pitch=0.5,dist=8,tgt=[0,0,2],mode3d=true;
onkeydown=e=>{if(e.key==='2')mode3d=false;if(e.key==='3')mode3d=true};
let drag=null,pan=false;
c.onmousedown=e=>{drag=[e.x,e.y];pan=e.button===2||e.shiftKey};
c.oncontextmenu=e=>e.preventDefault();
c.onmouseup=()=>drag=null;
c.onmousemove=e=>{if(!drag)return;
 const dx=(e.x-drag[0])/200,dy=(e.y-drag[1])/200;
 if(pan){const cy=Math.cos(yaw),sy=Math.sin(yaw);
  tgt[0]-=dx*dist*0.5*cy;tgt[2]+=dx*dist*0.5*sy;tgt[1]+=dy*dist*0.5;
  document.getElementById('follow').checked=false;}
 else{yaw+=dx;pitch=Math.max(-1.5,Math.min(1.5,pitch+dy));}
 drag=[e.x,e.y]};
c.onwheel=e=>{dist*=e.deltaY<0?0.9:1.1;e.preventDefault()};
function mvp(){
 const asp=c.width/c.height;
 let eye;
 if(mode3d){
  eye=[tgt[0]+dist*Math.cos(pitch)*Math.sin(yaw),
       tgt[1]-dist*Math.sin(pitch),
       tgt[2]-dist*Math.cos(pitch)*Math.cos(yaw)];
 }else{eye=[tgt[0],tgt[1]-dist,tgt[2]+1e-4];}
 // world is y-down (camera convention): use up = -y
 return mul(persp(0.9,asp,0.05,500),lookAt(eye,tgt,[0,-1,0]));
}
function frustum(T){ // T=[C(3), Rwc rows(9)] -> line segments
 if(!T)return null;
 const C=T.slice(0,3),R=T.slice(3);
 const s=0.25,corners=[[-s,-s*0.75,s*1.5],[s,-s*0.75,s*1.5],
  [s,s*0.75,s*1.5],[-s,s*0.75,s*1.5]];
 const W=corners.map(p=>[
  C[0]+R[0]*p[0]+R[1]*p[1]+R[2]*p[2],
  C[1]+R[3]*p[0]+R[4]*p[1]+R[5]*p[2],
  C[2]+R[6]*p[0]+R[7]*p[1]+R[8]*p[2]]);
 const col=[0,1,0.2],seg=[];
 for(let i=0;i<4;i++){
  seg.push(...C,...col,...W[i],...col);
  seg.push(...W[i],...col,...W[(i+1)%4],...col);}
 return buf(seg)}
async function cmd(v){await fetch('/cmd?op='+v)}
function flat(arr,col){const o=[];
 for(const p of arr)o.push(p[0],p[1],p[2],...col);return o}
function flatSeg(arr,col){const o=[];
 for(const s of arr)o.push(s[0],s[1],s[2],...col,s[3],s[4],s[5],...col);
 return o}
async function tick(){
 try{
  const s=await (await fetch('/state.json')).json();
  document.getElementById('stat').textContent=
   ` state=${s.state} kf=${s.stats.keyframes} pts=${s.stats.points}`+
   ` lines=${s.stats.lines} frames=${s.stats.frames}${s.paused?' [PAUSED]':''}`;
  if(document.getElementById('follow').checked&&s.pose)
   tgt=[s.pose[0],s.pose[1],s.pose[2]];
  bPts=buf(flat(s.points,[0.62,0.62,0.62]));
  bTraj=buf((()=>{const o=[];for(let i=1;i<s.trajectory.length;i++)
   o.push(...s.trajectory[i-1],0,0.66,1,...s.trajectory[i],0,0.66,1);
   return o})());
  bKf=buf(flat(s.keyframes,[1,0.66,0]));
  bLines=buf(flatSeg(s.lines||[],[0.2,1,0.4]));
  bCovis=buf(flatSeg(s.covis||[],[0.35,0.35,0.12]));
  bFrus=frustum(s.frustum);
 }catch(e){}
 setTimeout(tick,500)}
async function meshTick(){
 try{
  if(document.getElementById('mesh').checked){
   const m=await (await fetch('/mesh.json')).json();
   if(m.tris&&m.tris.length){bMesh=buf(m.tris);bMeshW=buf(m.wire||[]);}
   else{bMesh=null;bMeshW=null;}
  }
 }catch(e){}
 setTimeout(meshTick,5000)}
function render(){
 gl.clearColor(0.066,0.066,0.066,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.uniformMatrix4fv(locM,false,new Float32Array(mvp()));
 if(document.getElementById('mesh').checked&&bMesh){
  draw(bMesh,gl.TRIANGLES,1,1.0);draw(bMeshW,gl.LINES,1,0.25);}
 draw(bCovis,gl.LINES,1,0.8);
 draw(bPts,gl.POINTS,2.5);
 draw(bLines,gl.LINES);
 draw(bTraj,gl.LINES);
 draw(bKf,gl.POINTS,7.0);
 draw(bFrus,gl.LINES);
 requestAnimationFrame(render)}
tick();meshTick();render();
</script></body></html>"""


class LiveViewer:
    """Serve a live view of a running System; control it from the page.

    The ``pause`` verb gates the caller's feed loop via ``wait_if_paused()``
    (the reference's Viewer pause blocks tracking the same way,
    src/Viewer.cc:391-393).
    """

    def __init__(self, system, port: int = 0, max_points: int = 4000,
                 save_path: str = "live_map.npz"):
        self.system = system
        self.save_path = save_path
        self.max_points = max_points
        self._paused = threading.Event()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                url = urlparse(self.path)
                code = 200
                if url.path == "/":
                    body = _PAGE.encode()
                    ctype = "text/html"
                elif url.path == "/state.json":
                    body = json.dumps(viewer.state()).encode()
                    ctype = "application/json"
                elif url.path == "/mesh.json":
                    body = json.dumps(viewer.mesh_state()).encode()
                    ctype = "application/json"
                elif url.path == "/cmd":
                    op = parse_qs(url.query).get("op", [""])[0]
                    err = viewer.command(op)
                    code = 200 if err is None else 500
                    body = b"ok" if err is None else err.encode()
                    ctype = "text/plain"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    # -- state snapshot -----------------------------------------------------
    def state(self) -> dict:
        sysm = self.system
        st = sysm.store
        with st.lock:
            pts_sel = np.nonzero(st.pt_mask)[0]
            if len(pts_sel) > self.max_points:
                stride = len(pts_sel) // self.max_points + 1
                pts_sel = pts_sel[::stride]
            pts = st.pt_xyz[pts_sel]
            kfs = np.nonzero(st.kf_mask)[0]
            kf_C = np.einsum("kij,kj->ki", st.kf_R[kfs].transpose(0, 2, 1),
                             -st.kf_t[kfs]) if len(kfs) else np.zeros((0, 3))
            # line landmarks as 3-D segments (reference: MapDrawer draws
            # MapLines, src/MapDrawer.cc)
            lns = np.nonzero(st.ln_mask)[0][:1024]
            line_seg = np.concatenate(
                [st.ln_Xs[lns], st.ln_Xe[lns]], axis=1) \
                if len(lns) else np.zeros((0, 6))
            # covisibility-graph edges between keyframe centers (reference:
            # MapDrawer's graph pass, src/MapDrawer.cc)
            covis_seg = [np.round(np.concatenate(s), 3).tolist()
                         for s in covisibility_segments(st)[:2000]]
        traj = [
            (-R.T @ t).tolist() for _, R, t in sysm.trajectory[-2000:]
        ]
        pose = traj[-1] if traj else None
        # current camera frustum: [C(3), Rwc row-major(9)]
        frustum = None
        if traj:
            Rwc = sysm.tracker.R.T
            frustum = (np.round(-Rwc @ sysm.tracker.t, 4).tolist()
                       + np.round(Rwc.reshape(-1), 4).tolist())
        return {
            "state": int(sysm.tracker.state),
            "stats": sysm.map_statistics(),
            "points": np.round(pts, 3).tolist(),
            "keyframes": np.round(kf_C, 3).tolist(),
            "lines": np.round(line_seg, 3).tolist(),
            "covis": covis_seg,
            "trajectory": traj,
            "pose": pose,
            "frustum": frustum,
            "paused": self._paused.is_set(),
        }

    def mesh_state(self, max_tris: int = 20000) -> dict:
        """Decimated dense-mesh chunk stream for the 3-D page: interleaved
        [x,y,z,r,g,b] triangle vertices (+ wireframe segments), lit by a
        simple normal shade host-side (reference: the dense mesh GLSL path,
        src/PointCloudDrawer.cc + Shaders/)."""
        dm = self.system.dense_mapper
        if dm is None:
            return {"tris": [], "wire": []}
        V, F = dm.mesh_incremental()
        if len(F) == 0:
            return {"tris": [], "wire": []}
        if len(F) > max_tris:
            F = F[:: len(F) // max_tris + 1]
        tv = V[F]  # [T, 3, 3]
        n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        # lambert from a fixed light
        light = np.asarray([0.3, -0.8, 0.5])
        lam = np.abs(n @ light) * 0.6 + 0.25
        base = np.asarray([0.55, 0.6, 0.7])
        col = lam[:, None] * base[None]
        tris = np.concatenate(
            [tv, np.repeat(col[:, None, :], 3, axis=1)], axis=-1)
        wire = np.concatenate([
            np.concatenate([tv[:, 0], tv[:, 1]], -1),
            np.concatenate([tv[:, 1], tv[:, 2]], -1),
        ])[:: max(len(F) // 2000, 1)]
        wcol = np.full((len(wire), 3), 0.15)
        wire6 = np.concatenate(
            [wire[:, :3], wcol, wire[:, 3:], wcol], axis=-1)
        return {
            "tris": np.round(tris.reshape(-1), 3).tolist(),
            "wire": np.round(wire6.reshape(-1), 3).tolist(),
        }

    # -- control ------------------------------------------------------------
    def command(self, op: str) -> str | None:
        """Apply a control verb; returns None, or the text of a failed
        ``save`` write."""
        if op == "pause":
            self._paused.set()
        elif op == "resume":
            self._paused.clear()
        elif op == "save":
            st = self.system.store
            try:
                with st.lock:
                    serialization.save_atlas(self.save_path, st)
            except OSError as e:
                return f"save failed: {e}"
        elif op == "localization":
            self.system.activate_localization_mode()
        elif op == "mapping":
            self.system.deactivate_localization_mode()
        return None

    def wait_if_paused(self, timeout: float | None = None):
        """Call from the frame-feed loop; blocks while paused."""
        t0 = time.time()
        while self._paused.is_set():
            if timeout is not None and time.time() - t0 > timeout:
                break
            time.sleep(0.05)

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
