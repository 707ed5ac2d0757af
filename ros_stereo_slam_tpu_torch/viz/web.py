"""Self-contained interactive 3D map/trajectory viewer (reference C16).

TPU-native stance on the reference's Pangolin GL thread
(``reference/src/GLrender.cpp:34-313`` ``DrawTrajectory``): rendering
does not belong on the accelerator or in the frame loop at all — the run
writes a single offline ``map.html`` artifact that any browser opens with
no server, no network, and no dependencies (all JS inline, data embedded
as base64 typed arrays).

Feature parity with the Pangolin menu (``GLrender.cpp:51-62``): RGB vs
depth-heat point coloring, keyframe-frustum toggle, follow-camera playback
along the trajectory, point sparsity stride, point size — plus orbit /
pan / zoom mouse controls.
"""

from __future__ import annotations

import base64
import json

import numpy as np

_MAX_POINTS = 400_000


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode("ascii")


def export_html(
    path: str,
    poses: np.ndarray,  # (F, 4, 4) world-from-cam trajectory
    points: np.ndarray,  # (N, 3) map points (world)
    colors: np.ndarray | None = None,  # (N, 3) in [0,1] or [0,255]
    keyframe_idx: np.ndarray | None = None,  # indices into poses
    title: str = "ros_stereo_slam_tpu map",
) -> int:
    """Write the viewer; returns the number of embedded points."""
    poses = np.asarray(poses, np.float32)
    points = np.asarray(points, np.float32)
    good = np.isfinite(points).all(axis=1)
    points = points[good]
    if colors is not None:
        colors = np.asarray(colors)[good]
    if points.shape[0] > _MAX_POINTS:
        sel = np.random.default_rng(0).choice(
            points.shape[0], _MAX_POINTS, replace=False
        )
        points = points[sel]
        colors = colors[sel] if colors is not None else None
    n = int(points.shape[0])
    if colors is None:
        colors = np.full((n, 3), 200, np.uint8)
    else:
        colors = np.asarray(colors, np.float64)
        if colors.size and colors.max() <= 1.0 + 1e-6:
            colors = colors * 255.0
        colors = np.clip(colors, 0, 255).astype(np.uint8)

    traj = poses[:, :3, 3]
    # camera axes for frusta: columns of R (x right, y down, z forward)
    kf = (
        np.asarray(keyframe_idx, np.int32)
        if keyframe_idx is not None and len(np.atleast_1d(keyframe_idx))
        else np.arange(0, len(poses), max(1, len(poses) // 60), dtype=np.int32)
    )
    kf = kf[(kf >= 0) & (kf < len(poses))]
    kf_T = poses[kf]  # (K, 4, 4)

    payload = {
        "n": n,
        "pts": _b64(points),
        "cols": _b64(colors),
        "traj": _b64(traj.astype(np.float32)),
        "nTraj": int(traj.shape[0]),
        "kf": _b64(kf_T.astype(np.float32)),
        "nKf": int(kf_T.shape[0]),
        "title": title,
    }
    html = _TEMPLATE.replace("__DATA__", json.dumps(payload))
    with open(path, "w") as f:
        f.write(html)
    return n


_TEMPLATE = r"""<!doctype html>
<meta charset="utf-8"><title>slam map</title>
<style>
 html,body{margin:0;height:100%;background:#101014;color:#cfcfd6;
   font:12px system-ui,sans-serif;overflow:hidden}
 #ui{position:fixed;top:8px;left:8px;background:#1a1a22cc;padding:8px 10px;
   border-radius:6px;line-height:1.9;user-select:none}
 #ui label{display:block;white-space:nowrap}
 canvas{display:block}
 #hud{position:fixed;bottom:8px;left:8px;color:#8f8f9a}
</style>
<canvas id=c></canvas>
<div id=ui>
 <b id=t></b>
 <label><input type=checkbox id=rgb checked> RGB colors (off = depth heat)</label>
 <label><input type=checkbox id=frusta checked> keyframe frusta</label>
 <label><input type=checkbox id=follow> follow camera</label>
 <label>point size <input type=range id=psz min=1 max=5 value=2 style="width:80px"></label>
 <label>sparsity <input type=range id=stride min=1 max=16 value=1 style="width:80px"></label>
 <label>frame <input type=range id=frame min=0 max=0 value=0 style="width:140px"></label>
</div>
<div id=hud>drag: orbit &nbsp; shift-drag: pan &nbsp; wheel: zoom</div>
<script>
const D = __DATA__;
function f32(b64){const s=atob(b64),a=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new Float32Array(a.buffer);}
function u8(b64){const s=atob(b64),a=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return a;}
const P=f32(D.pts), C=u8(D.cols), TR=f32(D.traj), KF=f32(D.kf);
document.getElementById('t').textContent=D.title+" — "+D.n+" pts, "+D.nTraj+" poses";
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw();}
addEventListener('resize',rs);
// orbit state: target, yaw/pitch, distance
let cen=[0,0,0];
(function(){let n=D.nTraj;for(let i=0;i<n;i++){cen[0]+=TR[3*i];cen[1]+=TR[3*i+1];cen[2]+=TR[3*i+2];}
 if(n)for(let k=0;k<3;k++)cen[k]/=n;})();
let yaw=-0.6,pitch=-0.5,dist=0;
(function(){let r=1;for(let i=0;i<D.nTraj;i++){const dx=TR[3*i]-cen[0],dz=TR[3*i+2]-cen[2];
 r=Math.max(r,Math.hypot(dx,dz));}dist=r*2.2+10;})();
const ui=id=>document.getElementById(id);
ui('frame').max=Math.max(0,D.nTraj-1);ui('frame').value=ui('frame').max;
let drag=null;
cv.onmousedown=e=>{drag={x:e.clientX,y:e.clientY,shift:e.shiftKey};};
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return;const dx=e.clientX-drag.x,dy=e.clientY-drag.y;
 if(drag.shift){const s=dist/600;
   cen[0]-=(dx*Math.cos(yaw)+dy*Math.sin(yaw)*Math.sin(pitch))*s;
   cen[2]-=(-dx*Math.sin(yaw)+dy*Math.cos(yaw)*Math.sin(pitch))*s;
   cen[1]+=dy*Math.cos(pitch)*s;}
 else{yaw+=dx*0.005;pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.005));}
 drag={x:e.clientX,y:e.clientY,shift:drag.shift};draw();};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault();};
for(const id of['rgb','frusta','follow','psz','stride','frame'])
  ui(id).oninput=draw;
function camera(){
 if(ui('follow').checked&&D.nTraj){
   const i=+ui('frame').value;cen=[TR[3*i],TR[3*i+1],TR[3*i+2]];}
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 // rows of view rotation (world->cam)
 return {r0:[cy,0,-sy], r1:[sy*sp,cp,cy*sp], r2:[sy*cp,-sp,cy*cp]};
}
function proj(m,x,y,z,out){
 x-=cen[0];y-=cen[1];z-=cen[2];
 const zx=m.r2[0]*x+m.r2[1]*y+m.r2[2]*z+dist;
 if(zx<0.2)return false;
 const f=0.9*Math.min(W,H);
 out[0]=W/2+f*(m.r0[0]*x+m.r0[1]*y+m.r0[2]*z)/zx;
 out[1]=H/2+f*(m.r1[0]*x+m.r1[1]*y+m.r1[2]*z)/zx;
 out[2]=zx;return true;}
function draw(){
 ctx.fillStyle='#101014';ctx.fillRect(0,0,W,H);
 const m=camera(),o=[0,0,0],stride=+ui('stride').value,sz=+ui('psz').value;
 const rgb=ui('rgb').checked;
 const img=ctx.getImageData(0,0,W,H),buf=img.data;
 let zmin=1e9,zmax=-1e9;
 if(!rgb){for(let i=0;i<D.n;i+=stride){const y=P[3*i+1];
   if(y<zmin)zmin=y;if(y>zmax)zmax=y;}}
 for(let i=0;i<D.n;i+=stride){
  if(!proj(m,P[3*i],P[3*i+1],P[3*i+2],o))continue;
  const x0=o[0]|0,y0=o[1]|0;if(x0<0||y0<0||x0>=W-sz||y0>=H-sz)continue;
  let r,g,b;
  if(rgb){r=C[3*i];g=C[3*i+1];b=C[3*i+2];}
  else{const t=(P[3*i+1]-zmin)/(zmax-zmin+1e-9);
   r=255*Math.min(1,2*t);g=255*Math.min(1,2-2*Math.abs(t-0.5)*2);b=255*Math.min(1,2-2*t);}
  for(let dy=0;dy<sz;dy++)for(let dx=0;dx<sz;dx++){
   const k=4*((y0+dy)*W+x0+dx);buf[k]=r;buf[k+1]=g;buf[k+2]=b;buf[k+3]=255;}}
 ctx.putImageData(img,0,0);
 // trajectory polyline (red, like GLrender's)
 ctx.strokeStyle='#ff4545';ctx.lineWidth=1.6;ctx.beginPath();let started=false;
 const nshow=Math.min(D.nTraj,(+ui('frame').value)+1);
 for(let i=0;i<nshow;i++){
  if(!proj(m,TR[3*i],TR[3*i+1],TR[3*i+2],o)){started=false;continue;}
  if(started)ctx.lineTo(o[0],o[1]);else{ctx.moveTo(o[0],o[1]);started=true;}}
 ctx.stroke();
 if(ui('frusta').checked){
  ctx.strokeStyle='#58a6ff';ctx.lineWidth=1;
  const s=dist*0.012,a=[0,0,0],pts2=[];
  for(let k=0;k<D.nKf;k++){
   const T=KF.subarray(16*k,16*k+16);
   const cx=T[3],cyy=T[7],cz=T[11];
   const corn=[[-s,-s*0.6,1.6*s],[s,-s*0.6,1.6*s],[s,s*0.6,1.6*s],[-s,s*0.6,1.6*s]];
   if(!proj(m,cx,cyy,cz,a))continue;
   const ax=a[0],ay=a[1];pts2.length=0;let ok=true;
   for(const c of corn){
    const wx=cx+T[0]*c[0]+T[1]*c[1]+T[2]*c[2];
    const wy=cyy+T[4]*c[0]+T[5]*c[1]+T[6]*c[2];
    const wz=cz+T[8]*c[0]+T[9]*c[1]+T[10]*c[2];
    if(!proj(m,wx,wy,wz,a)){ok=false;break;}pts2.push([a[0],a[1]]);}
   if(!ok)continue;
   ctx.beginPath();
   for(let j=0;j<4;j++){ctx.moveTo(ax,ay);ctx.lineTo(pts2[j][0],pts2[j][1]);
    ctx.lineTo(pts2[(j+1)%4][0],pts2[(j+1)%4][1]);}
   ctx.stroke();}}
}
rs();
</script>
"""
