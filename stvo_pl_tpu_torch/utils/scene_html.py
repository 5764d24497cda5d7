"""Interactive 3-D scene export: the MRPT live scene's capability set
(src/sceneRepresentation.cpp:263-504,988-1009) as a single self-contained
HTML file — estimated + ground-truth trajectories, camera frustums,
keyframe markers, covariance ellipsoid, image viewport, per-frame HUD —
with orbit/zoom navigation and frame playback.  No external assets
(zero-egress friendly): the viewer is inline canvas-2D JS with a small
hand-rolled 3-D projection; frames are embedded as base64 PNG thumbnails.
(Numpy copy of stvo_pl_tpu/utils/scene_html.py.)
"""

from __future__ import annotations

import base64
import io
import json

import numpy as np


def _thumb_b64(img: np.ndarray, width: int = 320) -> str:
    from PIL import Image
    im = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    h = max(1, int(round(im.height * width / im.width)))
    im = im.resize((width, h))
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _cov_ellipsoid_axes(cov3: np.ndarray, scale: float = 2.0):
    """Principal axes (columns scaled by 2 sigma) of a 3x3 position
    covariance — the MRPT cov ellipsoid (sceneRepresentation.cpp:345-348)."""
    w, V = np.linalg.eigh(cov3)
    w = np.maximum(w, 0.0)
    return (V * (scale * np.sqrt(w))[None, :]).tolist()


def write_scene_html(path: str, poses: np.ndarray, stats=None,
                     gt_poses: np.ndarray | None = None,
                     images: dict[int, np.ndarray] | None = None,
                     cov: np.ndarray | None = None,
                     title: str = "stvo_pl_tpu scene"):
    """poses: [T, 4, 4] camera-to-world.  stats: list of per-frame dicts
    (err/ms/npt/nls/kf).  images: {frame_idx: grayscale array} embedded as
    the image viewport.  cov: [6, 6] (or [3, 3]) covariance of the latest
    pose for the ellipsoid."""
    poses = np.asarray(poses, dtype=np.float64)
    T = len(poses)
    stats = stats or [{} for _ in range(T)]
    kf = [bool(s.get("kf", False)) for s in stats]
    data = {
        "title": title,
        "pos": poses[:, :3, 3].round(4).tolist(),
        "rot": poses[:, :3, :3].round(5).tolist(),
        "gt": (np.asarray(gt_poses)[:, :3, 3].round(4).tolist()
               if gt_poses is not None else None),
        "kf": kf,
        "hud": [dict(err=round(float(s.get("err", 0.0)), 5),
                     ms=round(float(s.get("ms", 0.0)), 2),
                     npt=int(s.get("npt", 0)), nls=int(s.get("nls", 0)))
                for s in stats],
        "imgs": {str(k): _thumb_b64(v) for k, v in (images or {}).items()},
        "cov_axes": (_cov_ellipsoid_axes(np.asarray(cov)[:3, :3])
                     if cov is not None else None),
    }
    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    with open(path, "w") as f:
        f.write(html)


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>stvo scene</title>
<style>
 body{margin:0;background:#101218;color:#dde;font:13px monospace;overflow:hidden}
 #hud{position:absolute;left:10px;top:8px;white-space:pre;pointer-events:none}
 #img{position:absolute;right:10px;top:8px;border:1px solid #445;max-width:320px}
 #bar{position:absolute;left:0;right:0;bottom:0;padding:8px;background:#181b24}
 #fr{width:70%;vertical-align:middle}
 button{background:#283048;color:#dde;border:1px solid #456;margin-right:6px}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div><img id="img" style="display:none"/>
<div id="bar"><button id="play">&#9654;</button>
<input type="range" id="fr" min="0" value="0"/> <span id="lbl"></span></div>
<script>
const D = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight-40;}
rs(); addEventListener('resize', rs);
const T = D.pos.length;
document.getElementById('fr').max = T-1;
let yaw=-0.9, pitch=0.45, dist=0, ctr=[0,0,0], cur=T-1, playing=false;
(function(){ // fit view to trajectory
  let mn=[1e9,1e9,1e9], mx=[-1e9,-1e9,-1e9];
  for(const p of D.pos) for(let i=0;i<3;i++){mn[i]=Math.min(mn[i],p[i]);mx[i]=Math.max(mx[i],p[i]);}
  for(let i=0;i<3;i++) ctr[i]=(mn[i]+mx[i])/2;
  dist = 2.2*Math.max(1, Math.hypot(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2]));
})();
function proj(p){ // world -> screen (orbit cam around ctr; y-down world)
  let x=p[0]-ctr[0], y=p[1]-ctr[1], z=p[2]-ctr[2];
  let cx=Math.cos(yaw), sx=Math.sin(yaw);
  let x1=cx*x+sx*z, z1=-sx*x+cx*z;
  let cp=Math.cos(pitch), sp=Math.sin(pitch);
  let y2=cp*y-sp*z1, z2=sp*y+cp*z1;
  z2+=dist;
  if(z2<0.1) return null;
  const f=0.9*Math.min(W,H);
  return [W/2+f*x1/z2, H/2+f*y2/z2, z2];
}
function line(a,b,col,w){const A=proj(a),B=proj(b);if(!A||!B)return;
  ctx.strokeStyle=col;ctx.lineWidth=w||1;ctx.beginPath();ctx.moveTo(A[0],A[1]);ctx.lineTo(B[0],B[1]);ctx.stroke();}
function dot(a,col,r){const A=proj(a);if(!A)return;ctx.fillStyle=col;
  ctx.beginPath();ctx.arc(A[0],A[1],r||2.5,0,6.283);ctx.fill();}
function frustum(k,col){ // camera pyramid from pose k
  const R=D.rot[k], t=D.pos[k], s=0.45;
  const c=[[0,0,0]], pts=[[-.6,-.4,1],[.6,-.4,1],[.6,.4,1],[-.6,.4,1]];
  const w=pts.map(p=>[
    t[0]+s*(R[0][0]*p[0]+R[0][1]*p[1]+R[0][2]*p[2]),
    t[1]+s*(R[1][0]*p[0]+R[1][1]*p[1]+R[1][2]*p[2]),
    t[2]+s*(R[2][0]*p[0]+R[2][1]*p[1]+R[2][2]*p[2])]);
  for(let i=0;i<4;i++){line(t,w[i],col);line(w[i],w[(i+1)%4],col);}
}
function ellipsoid(){ if(!D.cov_axes) return; const t=D.pos[cur];
  const A=D.cov_axes; ctx.strokeStyle='#fa0';
  for(let u=0;u<24;u++){for(const [i,j] of [[0,1],[0,2],[1,2]]){
    const a0=6.283*u/24, a1=6.283*(u+1)/24;
    const p=(a)=>[t[0]+Math.cos(a)*A[0][i]+Math.sin(a)*A[0][j],
                  t[1]+Math.cos(a)*A[1][i]+Math.sin(a)*A[1][j],
                  t[2]+Math.cos(a)*A[2][i]+Math.sin(a)*A[2][j]];
    line(p(a0),p(a1),'#fa0');}}}
function grid(){ // ground grid at median y
  const ys=D.pos.map(p=>p[1]).sort((a,b)=>a-b), y=ys[ys.length>>1]+1.0;
  for(let i=-10;i<=10;i++){
    line([ctr[0]+i*2,y,ctr[2]-20],[ctr[0]+i*2,y,ctr[2]+20],'#1d2330');
    line([ctr[0]-20,y,ctr[2]+i*2],[ctr[0]+20,y,ctr[2]+i*2],'#1d2330');}}
function draw(){
  ctx.fillStyle='#101218';ctx.fillRect(0,0,W,H); grid();
  if(D.gt) for(let i=1;i<D.gt.length;i++) line(D.gt[i-1],D.gt[i],'#3a7',1.5);
  for(let i=1;i<=cur;i++) line(D.pos[i-1],D.pos[i],'#6af',2);
  for(let i=0;i<=cur;i++) if(D.kf[i]){dot(D.pos[i],'#f55',4);frustum(i,'#f77');}
  frustum(cur,'#ff0'); dot(D.pos[cur],'#ff0',4);
  if(cur===T-1) ellipsoid();
  const h=D.hud[cur]||{};
  document.getElementById('hud').textContent =
    D.title+"\nframe "+cur+"/"+(T-1)+"  err "+(h.err??'-')+"  "+(h.ms??'-')
    +" ms\npt "+(h.npt??'-')+"  ls "+(h.nls??'-')
    +(D.kf[cur]?"  [KF]":"")+"\ndrag: orbit  wheel: zoom";
  const im=document.getElementById('img');
  let best=null; for(const k of Object.keys(D.imgs)){if(+k<=cur&&(best===null||+k>best))best=+k;}
  if(best!==null){im.src='data:image/png;base64,'+D.imgs[best];im.style.display='block';}
  document.getElementById('lbl').textContent='frame '+cur;
  document.getElementById('fr').value=cur;
}
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
addEventListener('mouseup',()=>drag=false);
addEventListener('mousemove',e=>{if(!drag)return;
  yaw+=(e.clientX-lx)*0.008;pitch+=(e.clientY-ly)*0.008;
  pitch=Math.max(-1.5,Math.min(1.5,pitch));lx=e.clientX;ly=e.clientY;draw();});
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault();};
document.getElementById('fr').oninput=e=>{cur=+e.target.value;draw();};
document.getElementById('play').onclick=()=>{playing=!playing;};
setInterval(()=>{if(playing){cur=(cur+1)%T;draw();}},120);
draw();
</script></body></html>
"""
