"""Headless model viewer: standalone-HTML WebGL export of a reconstruction.

The reference ships a Qt5/OpenGL GUI whose ModelViewerWidget paints SfM
points, camera frusta, the lidar map, and SfM-point<->lidar-point association
lines colored by type (red=proj, blue=icp, yellow=ground)
(src/ui/model_viewer_widget.h:125-184). A Qt GUI is out of scope for a
headless package (SURVEY.md §7.1.7); this module provides the same
visualization as a zero-dependency artifact instead: one self-contained HTML
file (inline WebGL1, no CDN/network) with orbit/pan/zoom controls that any
browser opens.

A copy of colmap_pcd_tpu/io/viewer.py (host code, carried), so both packages
write the same bytes for one model.
"""

from __future__ import annotations

import base64
import json

import numpy as np

# association-type colors, matching the reference painters
# (model_viewer_widget lidar line colors: red=proj, blue=icp, yellow=ground)
LIDAR_PROJ, LIDAR_ICP, LIDAR_ICP_GROUND = 0, 1, 2
_ASSOC_COLOR = {
    LIDAR_PROJ: (230, 60, 60),
    LIDAR_ICP: (70, 110, 235),
    LIDAR_ICP_GROUND: (235, 220, 60),
}


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode("ascii")


def _frustum_lines(rec, image_id, scale: float):
    """8 line segments per camera: apex->4 corners + image-plane rectangle."""
    from ..ops import np_geom

    img = rec.images[image_id]
    cam = rec.cameras[img.camera_id]
    C = img.projection_center()
    qi = np_geom.quat_conj(np.asarray(img.qvec, np.float64))
    w, h = cam.width, cam.height
    f = float(np.asarray(cam.params)[0])
    corners_cam = np.asarray(
        [
            [-w / 2 / f, -h / 2 / f, 1.0],
            [w / 2 / f, -h / 2 / f, 1.0],
            [w / 2 / f, h / 2 / f, 1.0],
            [-w / 2 / f, h / 2 / f, 1.0],
        ]
    ) * scale
    corners = np_geom.quat_rotate(qi, corners_cam) + C
    segs = []
    for k in range(4):
        segs.append((C, corners[k]))
        segs.append((corners[k], corners[(k + 1) % 4]))
    return segs


def export_viewer_html(
    rec,
    output_path: str,
    lidar_pts: np.ndarray | None = None,
    max_lidar_points: int = 300_000,
    max_sfm_points: int = 1_000_000,
    frustum_scale: float = 0.4,
    title: str = "colmap_pcd_tpu model viewer",
) -> str:
    """Write a self-contained HTML viewer of `rec` (+ optional lidar map).

    Painted layers (each toggleable in the page):
      * SfM points (track colors),
      * camera frusta (green = registered),
      * the lidar map (gray, downsampled to max_lidar_points),
      * point<->lidar association lines colored by type
        (red=proj, blue=icp, yellow=ground).
    Returns output_path.
    """
    pids = list(rec.points3D.keys())[:max_sfm_points]
    if pids:
        sfm_xyz = np.asarray([rec.points3D[p].xyz for p in pids], np.float32)
        sfm_rgb = np.asarray([rec.points3D[p].color for p in pids], np.uint8)
        # default color for points with no extracted color: light gray
        dark = sfm_rgb.sum(axis=1) == 0
        sfm_rgb[dark] = (200, 200, 200)
    else:
        sfm_xyz = np.zeros((0, 3), np.float32)
        sfm_rgb = np.zeros((0, 3), np.uint8)

    cam_lines = []
    for iid in rec.registered_ids:
        cam_lines.extend(_frustum_lines(rec, iid, frustum_scale))
    if cam_lines:
        cam_xyz = np.asarray(cam_lines, np.float32).reshape(-1, 3)
    else:
        cam_xyz = np.zeros((0, 3), np.float32)

    assoc_xyz, assoc_rgb = [], []
    for store in (rec.lidar_points, rec.lidar_points_in_global):
        for pid, assoc in store.items():
            p = rec.points3D.get(pid)
            if p is None:
                continue
            c = _ASSOC_COLOR.get(int(assoc.type), (255, 255, 255))
            assoc_xyz.append(np.asarray(p.xyz, np.float32))
            assoc_xyz.append(np.asarray(assoc.point, np.float32))
            assoc_rgb.append(c)
            assoc_rgb.append(c)
    assoc_xyz = (
        np.asarray(assoc_xyz, np.float32) if assoc_xyz else np.zeros((0, 3), np.float32)
    )
    assoc_rgb = (
        np.asarray(assoc_rgb, np.uint8) if assoc_rgb else np.zeros((0, 3), np.uint8)
    )

    if lidar_pts is not None and len(lidar_pts):
        lp = np.asarray(lidar_pts, np.float32)
        if len(lp) > max_lidar_points:
            sel = np.linspace(0, len(lp) - 1, max_lidar_points).astype(np.int64)
            lp = lp[sel]
    else:
        lp = np.zeros((0, 3), np.float32)

    everything = np.concatenate([sfm_xyz, cam_xyz, lp]) if (len(sfm_xyz) + len(cam_xyz) + len(lp)) else np.zeros((1, 3), np.float32)
    center = everything.mean(axis=0)
    radius = float(np.percentile(np.linalg.norm(everything - center, axis=1), 95) + 1e-3)

    payload = {
        "sfm_xyz": _b64(sfm_xyz),
        "sfm_rgb": _b64(sfm_rgb),
        "cam_xyz": _b64(cam_xyz),
        "assoc_xyz": _b64(assoc_xyz),
        "assoc_rgb": _b64(assoc_rgb),
        "lidar_xyz": _b64(lp),
        "n_sfm": int(len(sfm_xyz)),
        "n_cam": int(len(cam_xyz)),
        "n_assoc": int(len(assoc_xyz)),
        "n_lidar": int(len(lp)),
        "center": [float(x) for x in center],
        "radius": radius,
        "stats": f"{rec.num_reg_images} images, {len(rec.points3D)} points, "
                 f"{len(rec.lidar_points) + len(rec.lidar_points_in_global)} lidar assocs",
    }
    html = _TEMPLATE.replace("__TITLE__", title).replace(
        "__DATA__", json.dumps(payload)
    )
    with open(output_path, "w") as f:
        f.write(html)
    return output_path


_TEMPLATE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 html,body{margin:0;height:100%;background:#101014;color:#ccc;font:12px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:rgba(0,0,0,.55);padding:8px 10px;border-radius:6px}
 #hud label{display:block;margin:2px 0;cursor:pointer}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">
 <b>__TITLE__</b><div id="stats"></div>
 <label><input type="checkbox" id="tog_sfm" checked> SfM points</label>
 <label><input type="checkbox" id="tog_cam" checked> camera frusta</label>
 <label><input type="checkbox" id="tog_lidar" checked> lidar map</label>
 <label><input type="checkbox" id="tog_assoc" checked> lidar associations</label>
 <label>point size <input type="range" id="psize" min="1" max="6" value="2" style="width:80px"></label>
 <div>drag: orbit &nbsp; shift-drag: pan &nbsp; wheel: zoom</div>
</div>
<script>
const D=__DATA__;
function f32(b){const s=atob(b),a=new Uint8Array(s.length);for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new Float32Array(a.buffer)}
function u8(b){const s=atob(b),a=new Uint8Array(s.length);for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return a}
const cv=document.getElementById('c'),gl=cv.getContext('webgl');
document.getElementById('stats').textContent=D.stats;
const vs=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;uniform float ps;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=ps;vc=col;}`;
const fs=`precision mediump float;varying vec3 vc;void main(){gl_FragColor=vec4(vc,1.0);}`;
function sh(t,s){const h=gl.createShader(t);gl.shaderSource(h,s);gl.compileShader(h);return h}
const pr=gl.createProgram();gl.attachShader(pr,sh(gl.VERTEX_SHADER,vs));gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(pr);gl.useProgram(pr);
const locP=gl.getAttribLocation(pr,'p'),locC=gl.getAttribLocation(pr,'col');
const uMVP=gl.getUniformLocation(pr,'mvp'),uPS=gl.getUniformLocation(pr,'ps');
function buf(data){const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);return b}
function rgbf(u){const f=new Float32Array(u.length);for(let i=0;i<u.length;i++)f[i]=u[i]/255;return f}
function solid(n,r,g,b){const f=new Float32Array(n*3);for(let i=0;i<n;i++){f[3*i]=r;f[3*i+1]=g;f[3*i+2]=b}return f}
const layers=[
 {pos:buf(f32(D.sfm_xyz)),col:buf(rgbf(u8(D.sfm_rgb))),n:D.n_sfm,mode:'pts',tog:'tog_sfm'},
 {pos:buf(f32(D.lidar_xyz)),col:buf(solid(D.n_lidar,0.45,0.45,0.48)),n:D.n_lidar,mode:'pts',tog:'tog_lidar'},
 {pos:buf(f32(D.cam_xyz)),col:buf(solid(D.n_cam,0.2,0.9,0.3)),n:D.n_cam,mode:'lines',tog:'tog_cam'},
 {pos:buf(f32(D.assoc_xyz)),col:buf(rgbf(u8(D.assoc_rgb))),n:D.n_assoc,mode:'lines',tog:'tog_assoc'},
];
let yaw=0.6,pitch=0.4,dist=D.radius*2.5,tx=D.center[0],ty=D.center[1],tz=D.center[2];
function mat(){
 const W=cv.width,H=cv.height,asp=W/H,fov=1.0,near=D.radius*0.002,far=D.radius*50;
 const fpr=1/Math.tan(fov/2);
 const P=[fpr/asp,0,0,0, 0,fpr,0,0, 0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0];
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const ex=tx+dist*cp*sy,ey=ty+dist*sp,ez=tz+dist*cp*cy;
 let zx=ex-tx,zy=ey-ty,zz=ez-tz;const zl=Math.hypot(zx,zy,zz);zx/=zl;zy/=zl;zz/=zl;
 let ux=0,uy=1,uz=0; // world up
 let x0=uy*zz-uz*zy,x1=uz*zx-ux*zz,x2=ux*zy-uy*zx;const xl=Math.hypot(x0,x1,x2);x0/=xl;x1/=xl;x2/=xl;
 const y0=zy*x2-zz*x1,y1=zz*x0-zx*x2,y2=zx*x1-zy*x0;
 const V=[x0,y0,zx,0, x1,y1,zy,0, x2,y2,zz,0,
  -(x0*ex+x1*ey+x2*ez),-(y0*ex+y1*ey+y2*ez),-(zx*ex+zy*ey+zz*ez),1];
 // P*V (column major)
 const M=new Float32Array(16);
 for(let r=0;r<4;r++)for(let c=0;c<4;c++){let s=0;for(let k=0;k<4;k++)s+=P[k*4+r]*V[c*4+k];M[c*4+r]=s}
 return M;
}
function draw(){
 cv.width=innerWidth*devicePixelRatio;cv.height=innerHeight*devicePixelRatio;
 gl.viewport(0,0,cv.width,cv.height);
 gl.clearColor(0.063,0.063,0.078,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.enable(gl.DEPTH_TEST);
 gl.uniformMatrix4fv(uMVP,false,mat());
 gl.uniform1f(uPS,parseFloat(document.getElementById('psize').value)*devicePixelRatio);
 for(const L of layers){
  if(!L.n||!document.getElementById(L.tog).checked)continue;
  gl.bindBuffer(gl.ARRAY_BUFFER,L.pos);gl.enableVertexAttribArray(locP);gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,L.col);gl.enableVertexAttribArray(locC);gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
  gl.drawArrays(L.mode==='pts'?gl.POINTS:gl.LINES,0,L.n);
 }
 requestAnimationFrame(draw);
}
let drag=null;
cv.onmousedown=e=>drag={x:e.clientX,y:e.clientY,shift:e.shiftKey};
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return;const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
 if(drag.shift){const s=dist*0.0015;const cy=Math.cos(yaw),sy=Math.sin(yaw);
  tx-=s*(dx*cy);tz+=s*(dx*sy);ty+=s*dy;}
 else{yaw-=dx*0.005;pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.005));}};
onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);dist=Math.max(D.radius*0.02,Math.min(D.radius*40,dist));};
draw();
</script></body></html>
"""
