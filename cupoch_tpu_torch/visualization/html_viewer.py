"""A self-contained, navigable HTML viewer.

cupoch's Visualizer runs a GLFW window with mouse-driven view control
(visualizer/visualizer.cpp:256-299 and the mouse and scroll handlers of
visualizer_callback.cpp). A headless host exports a single HTML file
instead: the geometry embedded as base64 (float32 points, clipped
float32 colours, uint32 edge lists) and a small vanilla WebGL renderer
(no external scripts, so it works with no network) with ViewControl's
interactions:

  drag           orbit   (ViewControl::Rotate, view_control.cpp:243)
  wheel          zoom    (ViewControl::Scale)
  shift+drag /
  right-drag     pan     (ViewControl::Translate)
  R              reset   (ResetViewPoint)

The geometries' arrays are copied from their device once each; the file
is the same whether they lie on the card or on the CPU.
`draw_geometries(..., filename="scene.html")` routes here.
"""
from __future__ import annotations

import base64
import json

import numpy as np

# filled by str.replace, so the CSS needs no %-escapes
_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>%TITLE%</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#111}
 #c{width:100%;height:100%;display:block}
 #hud{position:fixed;left:8px;top:6px;color:#9a9;font:12px monospace;
      pointer-events:none;white-space:pre}
</style></head>
<body><canvas id="c"></canvas><div id="hud"></div>
<script>
"use strict";
const SCENE = %SCENE%;
function decode(b64, ctor){
  const s = atob(b64); const u = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) u[i] = s.charCodeAt(i);
  return new ctor(u.buffer);
}
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias:true});
const VS = `
attribute vec3 pos; attribute vec3 col;
uniform mat4 mvp; uniform float psize;
varying vec3 vcol;
void main(){ gl_Position = mvp*vec4(pos,1.0);
  gl_PointSize = psize; vcol = col; }`;
const FS = `
precision mediump float; varying vec3 vcol;
void main(){ gl_FragColor = vec4(vcol,1.0); }`;
function shader(type, src){
  const s = gl.createShader(type); gl.shaderSource(s, src);
  gl.compileShader(s); return s; }
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const aPos = gl.getAttribLocation(prog, "pos");
const aCol = gl.getAttribLocation(prog, "col");
const uMvp = gl.getUniformLocation(prog, "mvp");
const uPsz = gl.getUniformLocation(prog, "psize");
let nPts = 0;
const draws = [];
let lo = [1e30,1e30,1e30], hi = [-1e30,-1e30,-1e30];
for (const g of SCENE.geoms){
  const pts = decode(g.points, Float32Array);
  nPts += pts.length/3;
  for (let i = 0; i < pts.length; i += 3)
    for (let k = 0; k < 3; k++){
      if (pts[i+k] < lo[k]) lo[k] = pts[i+k];
      if (pts[i+k] > hi[k]) hi[k] = pts[i+k]; }
  let cols;
  if (g.colors) cols = decode(g.colors, Float32Array);
  else { cols = new Float32Array(pts.length);
    for (let i = 0; i < cols.length; i += 3){
      cols[i] = 0.55; cols[i+1] = 0.75; cols[i+2] = 0.95; } }
  const pb = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, pb);
  gl.bufferData(gl.ARRAY_BUFFER, pts, gl.STATIC_DRAW);
  const cb = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, cb);
  gl.bufferData(gl.ARRAY_BUFFER, cols, gl.STATIC_DRAW);
  let eb = null, nIdx = 0;
  if (g.lines){
    const idx = decode(g.lines, Uint32Array);
    eb = gl.createBuffer(); nIdx = idx.length;
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, eb);
    gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,
                  new Uint16Array(0), gl.STATIC_DRAW);
    // 32-bit indices need OES_element_index_uint
    gl.getExtension("OES_element_index_uint");
    gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, idx, gl.STATIC_DRAW);
  }
  draws.push({pb, cb, eb, n: pts.length/3, nIdx,
              mode: g.mode || "points"});
}
const ctr = [(lo[0]+hi[0])/2, (lo[1]+hi[1])/2, (lo[2]+hi[2])/2];
const diag = Math.hypot(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2]) || 1;
let theta, phi, dist, target, psize;
function reset(){
  theta = 0.5; phi = 0.9; dist = diag*1.6;
  target = ctr.slice(); psize = SCENE.point_size; }
reset();
function mat(){
  const w = canvas.width, h = canvas.height;
  const eye = [
    target[0] + dist*Math.cos(phi)*Math.cos(theta),
    target[1] + dist*Math.sin(phi),
    target[2] + dist*Math.cos(phi)*Math.sin(theta)];
  const f = norm3(sub3(target, eye));
  const r = norm3(cross3(f, [0,1,0]));
  const u = cross3(r, f);
  const near = diag*0.01, far = diag*20;
  const fy = 1/Math.tan(0.30), fx = fy*h/w;
  // column-major mvp = proj * view; w_clip = f.(p - eye) > 0 for
  // points in front of the camera
  const tx = -dot3(r, eye), ty = -dot3(u, eye), tz = dot3(f, eye);
  const A = -(far+near)/(far-near), B = -2*far*near/(far-near);
  return new Float32Array([
    fx*r[0], fy*u[0], A*-f[0], f[0],
    fx*r[1], fy*u[1], A*-f[1], f[1],
    fx*r[2], fy*u[2], A*-f[2], f[2],
    fx*tx,   fy*ty,   A*tz + B, -tz]);
}
function sub3(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function cross3(a,b){return [a[1]*b[2]-a[2]*b[1],
  a[2]*b[0]-a[0]*b[2], a[0]*b[1]-a[1]*b[0]];}
function norm3(a){const n=Math.hypot(a[0],a[1],a[2])||1;
  return [a[0]/n,a[1]/n,a[2]/n];}
function render(){
  const dpr = window.devicePixelRatio || 1;
  canvas.width = canvas.clientWidth*dpr;
  canvas.height = canvas.clientHeight*dpr;
  gl.viewport(0, 0, canvas.width, canvas.height);
  const bg = SCENE.background;
  gl.clearColor(bg[0], bg[1], bg[2], 1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(uMvp, false, mat());
  gl.uniform1f(uPsz, psize);
  for (const d of draws){
    gl.bindBuffer(gl.ARRAY_BUFFER, d.pb);
    gl.enableVertexAttribArray(aPos);
    gl.vertexAttribPointer(aPos, 3, gl.FLOAT, false, 0, 0);
    gl.bindBuffer(gl.ARRAY_BUFFER, d.cb);
    gl.enableVertexAttribArray(aCol);
    gl.vertexAttribPointer(aCol, 3, gl.FLOAT, false, 0, 0);
    if (d.eb){
      gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, d.eb);
      gl.drawElements(gl.LINES, d.nIdx, gl.UNSIGNED_INT, 0);
    }
    if (d.mode === "points") gl.drawArrays(gl.POINTS, 0, d.n);
  }
  document.getElementById("hud").textContent =
    SCENE.title + "  |  " + nPts.toLocaleString() + " pts  |  " +
    "drag orbit - wheel zoom - shift-drag pan - R reset";
}
let drag = null;
canvas.addEventListener("mousedown", e => {
  drag = {x: e.clientX, y: e.clientY,
          pan: e.shiftKey || e.button === 2}; });
window.addEventListener("mouseup", () => drag = null);
window.addEventListener("mousemove", e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan){
    const s = dist*0.0015;
    const eyeDir = [Math.cos(phi)*Math.cos(theta), Math.sin(phi),
                    Math.cos(phi)*Math.sin(theta)];
    const r = norm3(cross3(eyeDir, [0,1,0]));
    const u = cross3(r, eyeDir);
    for (let k = 0; k < 3; k++)
      target[k] += r[k]*dx*s + u[k]*dy*s;
  } else {
    theta += dx*0.008;
    phi = Math.min(1.55, Math.max(-1.55, phi + dy*0.008));
  }
  render(); });
canvas.addEventListener("wheel", e => {
  e.preventDefault();
  dist *= Math.exp(e.deltaY*0.001);
  render(); }, {passive:false});
canvas.addEventListener("contextmenu", e => e.preventDefault());
window.addEventListener("keydown", e => {
  if (e.key === "r" || e.key === "R"){ reset(); render(); }
  if (e.key === "+" ){ psize += 1; render(); }
  if (e.key === "-" ){ psize = Math.max(1, psize-1); render(); }});
window.addEventListener("resize", render);
render();
</script></body></html>
"""


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()) \
        .decode("ascii")


def export_html_viewer(geometry_list, filename: str,
                       window_name: str = "cupoch_tpu_torch",
                       max_points: int = 2_000_000,
                       render_option=None) -> bool:
    """Write a single-file navigable viewer of the geometries.

    Points and vertex colours are embedded as base64 float32; meshes
    draw as their wireframe edge lists, LineSet and Graph as their own
    edges. A cloud above `max_points` is subsampled uniformly
    (`default_rng(0)`), and then draws without edges."""
    from .render_option import RenderOption
    from .visualizer import _geometry_arrays

    opt = render_option or RenderOption()
    geoms = []
    for g in geometry_list:
        pts, cols, lines = _geometry_arrays(g)
        if pts.shape[0] == 0:
            continue
        pts = np.asarray(pts, np.float32)
        if pts.shape[0] > max_points:
            sel = np.random.default_rng(0).choice(
                pts.shape[0], max_points, replace=False)
            pts = pts[sel]
            cols = cols[sel] if cols is not None else None
            lines = None  # the edges no longer index the kept subset
        entry = {"points": _b64(pts), "mode": "points"}
        if cols is not None:
            entry["colors"] = _b64(
                np.clip(np.asarray(cols, np.float32), 0, 1))
        if lines is not None and len(lines):
            entry["lines"] = _b64(
                np.asarray(lines, np.uint32).reshape(-1))
            entry["mode"] = "lines"
        geoms.append(entry)
    scene = {
        "title": window_name,
        "geoms": geoms,
        "point_size": float(opt.point_size),
        "background": [float(c) for c in opt.background_color[:3]],
    }
    html = _TEMPLATE.replace("%TITLE%", window_name) \
        .replace("%SCENE%", json.dumps(scene))
    with open(filename, "w") as f:
        f.write(html)
    return True
