"""Interactive web export of scene point clouds with per-mode toggles.

Reference parity: the reference visualizer renders every stage through
pyviz3d's web export — one point set per mode (gt / stage-1 masks / lifted 2D
masks / per-class stage-2 / refined final), each with a visibility checkbox
(reference: visualization/visualize_scannet200.py:452-640, save at :722).
pyviz3d emits a directory that needs an HTTP server and ships bundled JS.

This build writes ONE self-contained ``index.html``: a vanilla-WebGL point
renderer (orbit/pan/zoom), the positions once as base64 float32, and one
base64 uint8 RGB layer per mode with a visibility checkbox and an instance
legend. No external scripts (zero-egress friendly), opens from ``file://``.
The port's copy of beyondff_tpu/visualization/webviz.py: the same inputs give
the same ``index.html`` bytes.
"""

from __future__ import annotations

import base64
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>BeyondFF-TPU scene: __TITLE__</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#16181d;color:#ddd;
   font:13px/1.4 system-ui,sans-serif}
 #c{position:absolute;inset:0;width:100%;height:100%}
 #panel{position:absolute;top:10px;left:10px;background:rgba(22,24,29,.88);
   border:1px solid #333;border-radius:6px;padding:10px 12px;max-height:92vh;
   overflow:auto;min-width:220px}
 #panel h1{font-size:14px;margin:0 0 6px}
 .layer{margin:3px 0}
 .legend{margin:2px 0 6px 22px;display:none}
 .legend div{display:flex;align-items:center;gap:6px;margin:1px 0}
 .sw{width:10px;height:10px;border-radius:2px;display:inline-block;flex:none}
 label{cursor:pointer;user-select:none}
 input[type=range]{width:110px;vertical-align:middle}
 #help{position:absolute;bottom:8px;left:10px;color:#888;font-size:12px}
</style></head><body>
<canvas id="c"></canvas>
<div id="panel"><h1>__TITLE__</h1>
 <div>point size <input type="range" id="ps" min="1" max="8" step="0.5" value="__PSIZE__"></div>
 <div id="layers"></div>
</div>
<div id="help">drag: orbit &nbsp; shift-drag / right-drag: pan &nbsp; wheel: zoom &nbsp; click layer name: legend</div>
<script>
"use strict";
const N = __N__;
function b64f32(s){const b=atob(s),n=b.length,u=new Uint8Array(n);
  for(let i=0;i<n;i++)u[i]=b.charCodeAt(i);return new Float32Array(u.buffer);}
function b64u8(s){const b=atob(s),n=b.length,u=new Uint8Array(n);
  for(let i=0;i<n;i++)u[i]=b.charCodeAt(i);return u;}
const POS = b64f32("__POS__");
const LAYERS = __LAYERS__;  // [{name, rgb(b64), on, legend:[[label,#hex],...]}]

const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias:false});
const vs=`attribute vec3 p;attribute vec3 c;uniform mat4 mvp;uniform float ps;
 varying vec3 vc;void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;vc=c;}`;
const fs=`precision mediump float;varying vec3 vc;
 void main(){gl_FragColor=vec4(vc,1.);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);gl.compileShader(o);
  if(!gl.getShaderParameter(o,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(o);return o;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(prog);gl.useProgram(prog);
const aP=gl.getAttribLocation(prog,"p"),aC=gl.getAttribLocation(prog,"c");
const uM=gl.getUniformLocation(prog,"mvp"),uS=gl.getUniformLocation(prog,"ps");
const posBuf=gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER,posBuf);gl.bufferData(gl.ARRAY_BUFFER,POS,gl.STATIC_DRAW);
for(const L of LAYERS){L.buf=gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER,L.buf);
  gl.bufferData(gl.ARRAY_BUFFER,b64u8(L.rgb),gl.STATIC_DRAW);delete L.rgb;}

// centroid + radius for the camera
let cx=0,cy=0,cz=0;for(let i=0;i<N;i++){cx+=POS[3*i];cy+=POS[3*i+1];cz+=POS[3*i+2];}
cx/=N;cy/=N;cz/=N;let r2=0;
for(let i=0;i<N;i++){const dx=POS[3*i]-cx,dy=POS[3*i+1]-cy,dz=POS[3*i+2]-cz;
  const d=dx*dx+dy*dy+dz*dz;if(d>r2)r2=d;}
const R=Math.sqrt(r2)||1;
let theta=-0.7,phi=1.0,dist=2.2*R,tx=cx,ty=cy,tz=cz,psize=__PSIZE__;

function mat(){
 const w=canvas.width,h=canvas.height,asp=w/h,f=1/Math.tan(0.4);
 const zn=0.01*R,zf=20*R;
 const ex=tx+dist*Math.sin(phi)*Math.cos(theta),
       ey=ty+dist*Math.sin(phi)*Math.sin(theta),
       ez=tz+dist*Math.cos(phi);
 // lookAt (up = +z, scan scenes are z-up)
 let zx=ex-tx,zy=ey-ty,zz=ez-tz;const zl=Math.hypot(zx,zy,zz);zx/=zl;zy/=zl;zz/=zl;
 let xx=-zy,xy=zx,xz=0;const xl=Math.hypot(xx,xy,xz)||1;xx/=xl;xy/=xl;xz/=xl;
 const yx=zy*xz-zz*xy,yy=zz*xx-zx*xz,yz=zx*xy-zy*xx;
 const tvx=-(xx*ex+xy*ey+xz*ez),tvy=-(yx*ex+yy*ey+yz*ez),tvz=-(zx*ex+zy*ey+zz*ez);
 const p00=f/asp,p11=f,p22=(zf+zn)/(zn-zf),p23=2*zf*zn/(zn-zf);
 return new Float32Array([
  p00*xx,p11*yx,p22*zx,-zx,
  p00*xy,p11*yy,p22*zy,-zy,
  p00*xz,p11*yz,p22*zz,-zz,
  p00*tvx,p11*tvy,p22*tvz+p23,-tvz]);
}
function draw(){
 const dpr=window.devicePixelRatio||1;
 const w=canvas.clientWidth*dpr,h=canvas.clientHeight*dpr;
 if(canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h;}
 gl.viewport(0,0,w,h);gl.clearColor(0.086,0.094,0.113,1);
 gl.enable(gl.DEPTH_TEST);gl.depthFunc(gl.LEQUAL);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.uniformMatrix4fv(uM,false,mat());gl.uniform1f(uS,psize);
 gl.bindBuffer(gl.ARRAY_BUFFER,posBuf);
 gl.enableVertexAttribArray(aP);gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
 for(const L of LAYERS){if(!L.on)continue;
  gl.bindBuffer(gl.ARRAY_BUFFER,L.buf);
  gl.enableVertexAttribArray(aC);
  gl.vertexAttribPointer(aC,3,gl.UNSIGNED_BYTE,true,0,0);
  gl.drawArrays(gl.POINTS,0,N);}
}
let dirty=true;function tick(){if(dirty){dirty=false;draw();}requestAnimationFrame(tick);}
requestAnimationFrame(tick);
window.addEventListener("resize",()=>dirty=true);

// ---- controls
let drag=0,lx=0,ly=0;
canvas.addEventListener("contextmenu",e=>e.preventDefault());
canvas.addEventListener("mousedown",e=>{drag=(e.button===2||e.shiftKey)?2:1;lx=e.clientX;ly=e.clientY;});
window.addEventListener("mouseup",()=>drag=0);
window.addEventListener("mousemove",e=>{
 if(!drag)return;const dx=e.clientX-lx,dy=e.clientY-ly;lx=e.clientX;ly=e.clientY;
 if(drag===1){theta-=dx*0.008;phi=Math.min(Math.PI-0.05,Math.max(0.05,phi-dy*0.008));}
 else{const s=dist*0.0016;
  tx+=s*(Math.sin(theta)*dx+Math.cos(phi)*Math.cos(theta)*dy);
  ty+=s*(-Math.cos(theta)*dx+Math.cos(phi)*Math.sin(theta)*dy);
  tz+=s*(-Math.sin(phi)*dy);}
 dirty=true;});
canvas.addEventListener("wheel",e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.001);dist=Math.min(40*R,Math.max(0.05*R,dist));dirty=true;},
 {passive:false});
document.getElementById("ps").addEventListener("input",e=>{psize=+e.target.value;dirty=true;});

// ---- layer panel
const panel=document.getElementById("layers");
LAYERS.forEach((L,i)=>{
 const d=document.createElement("div");d.className="layer";
 const cb=document.createElement("input");cb.type="checkbox";cb.checked=L.on;cb.id="cb"+i;
 cb.addEventListener("change",()=>{L.on=cb.checked;dirty=true;});
 const lab=document.createElement("label");lab.textContent=" "+L.name;lab.htmlFor="cb"+i;
 d.appendChild(cb);d.appendChild(lab);panel.appendChild(d);
 if(L.legend&&L.legend.length){
  const lg=document.createElement("div");lg.className="legend";
  for(const [t,c] of L.legend){const row=document.createElement("div");
   const sw=document.createElement("span");sw.className="sw";sw.style.background=c;
   row.appendChild(sw);row.appendChild(document.createTextNode(t));lg.appendChild(row);}
  panel.appendChild(lg);
  lab.addEventListener("click",e=>{e.preventDefault();
   lg.style.display=lg.style.display==="block"?"none":"block";});
 }
});
</script></body></html>
"""


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


class WebScene:
    """Accumulates color layers over one point cloud, then writes index.html.

    Mirrors the reference's pyviz3d usage: ``add_layer`` per mode ≈
    ``vis.add_points(name, ..., visible=...)`` and :meth:`save` ≈
    ``vis.save(path)`` (visualize_scannet200.py:459, :722)."""

    def __init__(self, xyz: np.ndarray, max_points: int = 400_000):
        xyz = np.asarray(xyz, np.float32)
        self._sel: Optional[np.ndarray] = None
        if xyz.shape[0] > max_points:
            rng = np.random.default_rng(0)
            self._sel = np.sort(rng.choice(xyz.shape[0], max_points, replace=False))
            xyz = xyz[self._sel]
        self.xyz = xyz
        self.layers: List[Dict] = []

    def add_layer(self, name: str, rgb: np.ndarray, visible: bool = False,
                  legend: Optional[Sequence[Tuple[str, np.ndarray]]] = None) -> None:
        rgb = np.asarray(rgb, np.uint8)
        if self._sel is not None:
            if rgb.shape[0] <= int(self._sel[-1]):
                raise ValueError(f"layer {name!r}: {rgb.shape[0]} colors vs "
                                 f"{int(self._sel[-1]) + 1}+ points")
            rgb = rgb[self._sel]
        if rgb.shape[0] != self.xyz.shape[0]:
            raise ValueError(f"layer {name!r}: {rgb.shape[0]} colors vs "
                             f"{self.xyz.shape[0]} points")
        leg = [[str(t), "#%02x%02x%02x" % tuple(int(v) for v in c)]
               for t, c in (legend or [])]
        self.layers.append({"name": name, "rgb": _b64(rgb), "on": bool(visible),
                            "legend": leg})

    def add_instance_layer(self, name: str, masks: np.ndarray,
                           labels: Optional[Sequence[str]] = None,
                           base_rgb: Optional[np.ndarray] = None,
                           visible: bool = False) -> None:
        """Instance masks colored over a grey (or RGB) base, with a legend —
        the reference's per-mode coloring loop (visualize_scannet200.py:496-505)."""
        from beyondff_tpu_torch.visualization.visualize import _palette

        n_raw = masks.shape[1] if getattr(masks, "ndim", 2) == 2 else len(self.xyz)
        base = (np.asarray(base_rgb, np.uint8).copy() if base_rgb is not None
                else np.full((n_raw, 3), 150, np.uint8))
        colors = _palette(max(len(masks), 1))
        legend = []
        for i, m in enumerate(np.asarray(masks).astype(bool)):
            base[m] = colors[i]
            if labels is not None and i < len(labels):
                legend.append((f"{i}: {labels[i]}", colors[i]))
        self.add_layer(name, base, visible=visible, legend=legend)

    def save(self, out_dir: str, title: str = "scene", point_size: float = 2.5) -> str:
        os.makedirs(out_dir, exist_ok=True)
        import json

        html = (_HTML
                .replace("__TITLE__", title)
                .replace("__N__", str(self.xyz.shape[0]))
                .replace("__PSIZE__", str(point_size))
                .replace("__POS__", _b64(self.xyz))
                .replace("__LAYERS__", json.dumps(self.layers)))
        path = os.path.join(out_dir, "index.html")
        with open(path, "w") as f:
            f.write(html)
        return path


def export_scene(cfg, scene_id: str, class_names: Sequence[str] = (),
                 out_dir: str = "visualization_out", modes: Sequence[str] = ("all",),
                 max_points: int = 400_000) -> str:
    """One command -> one interactive HTML for a scene: RGB + GT + stage-1 +
    per-class lifted/refined layers, mirroring the reference's mode toggles
    (visualize_scannet200.py:651-722)."""
    from beyondff_tpu_torch.utils import io as bio

    want = set(modes)

    def on(m):
        return "all" in want or m in want

    def load_stage(*parts):
        """Stage dict tolerant of .pth / .npz on disk (either format may
        have been written depending on cfg.output_format)."""
        base = os.path.join(*parts)
        for ext in (".pth", ".npz"):
            if os.path.exists(base + ext):
                return bio.load_stage_dict(base + ext)
        raise FileNotFoundError(base)

    # full (N, >=6) rows: xyz + rgb when present (load_point_cloud trims to xyz)
    pts = np.load(os.path.join(cfg.paths.scene_npy_dir, f"{scene_id}.npy"))
    scene = WebScene(pts[:, :3], max_points=max_points)
    raw_rgb = None
    if pts.shape[1] >= 6:
        raw_rgb = pts[:, 3:6]
        if raw_rgb.max() <= 1.001:  # stored normalized
            raw_rgb = raw_rgb * 255.0
        raw_rgb = np.clip(raw_rgb, 0, 255).astype(np.uint8)
        scene.add_layer("rgb", raw_rgb, visible=True)

    if on("gt"):
        try:
            from beyondff_tpu_torch.data import scannet200
            from beyondff_tpu_torch.pipeline.evaluate import load_gt_scene
            from beyondff_tpu_torch.visualization.visualize import scannet200_bench

            gt = load_gt_scene(os.path.join(cfg.paths.gt_dir, f"{scene_id}.pth"))
            ids = np.unique(gt["inst"])
            ids = ids[ids >= 0]
            masks = (np.stack([gt["inst"] == i for i in ids]) if len(ids)
                     else np.zeros((0, len(gt["inst"])), bool))
            labels = []
            for i in ids:
                b = scannet200_bench(gt, i)
                labels.append(str(scannet200.CLASS_LABELS_200[b]) if 0 <= b < 200 else "?")
            scene.add_instance_layer("gt instances", masks, labels, base_rgb=raw_rgb)
        except (FileNotFoundError, OSError):
            pass
    if on("stage1"):
        try:
            from beyondff_tpu_torch.pipeline.refinement import decode_stage1

            d = decode_stage1(load_stage(cfg.paths.stage_1_results_dir, scene_id))
            scene.add_instance_layer("stage-1 masks", np.asarray(d["ins"]),
                                     d["final_class"], base_rgb=raw_rgb)
        except (FileNotFoundError, OSError):
            pass
    for cls in class_names:
        if on("mask3d"):
            try:
                d = load_stage(cfg.paths.mask_3d_dir, cls, scene_id)
                scene.add_instance_layer(f"lifted 2d: {cls}", np.asarray(d["ins"]),
                                         d["final_class"], base_rgb=raw_rgb)
            except (FileNotFoundError, OSError):
                pass
        if on("refined"):
            try:
                d = load_stage(cfg.paths.final_output_dir, cls, scene_id)
                scene.add_instance_layer(f"refined: {cls}", np.asarray(d["ins"]),
                                         d["final_class"], base_rgb=raw_rgb)
            except (FileNotFoundError, OSError):
                pass

    return scene.save(os.path.join(out_dir, scene_id, "web"),
                      title=f"{scene_id}" + (f" [{', '.join(class_names)}]"
                                             if class_names else ""))
