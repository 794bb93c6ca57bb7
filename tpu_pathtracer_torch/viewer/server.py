"""Interactive viewer: a stdlib HTTP server + single-page UI around the App.

Counterpart: `tpu_pathtracer/viewer/server.py` (`_PAGE` copied verbatim,
`ViewerState`, `make_handler`, `main`): the headless stand-in for the
reference's GLFW/ImGui frontend with full Controls-window parity
(ui_windows.h:73-246). Every knob the reference exposes is a mouse-
reachable widget on `/`; the frame supports drag-orbit, scroll-zoom and
hover-pick (callbacks.h:95-150), hover-picking drives the Sampling-PDF
heatmap panel (ui_windows.h:252-350) and the Profiler panel mirrors
renderProfilerWindow. The App runs on the device it is given.

Run: python -m tpu_pathtracer_torch.viewer.server --device cuda \
         [--port 8000] [--scene cbox_quads ...]
Endpoints:
  GET /            control page
  GET /frame.png   current accumulated frame
  GET /heatmap.png?prim=3&src=radiosity|counts[&topk=K]
  GET /state[?prim=N]  JSON app state (config, stats, profiler, grid)
  GET /profiler    stage-timing summary (text)
  GET /profiler.svg
  GET /profiler/reset | /profiler/enable?on=0|1
  GET /profiler/kernel  phase split of one live render pass, traced by
        utils.kernel_profile.kernel_profile_traced, with the pass's host
        syncs by site, RNG draws and guided sampler calls by path
        (kernel or eager), lane occupancy and wavefront
        iterations by how they ran (graph replay, capture, eager) (JSON)
  GET /scenes      loadable scenes: builtins + scenes/*.obj|*.pbrt
  GET /orbit?yaw=5&pitch=0&zoom=0
  GET /set?mode=mis&spp=64  (any Config field)
  GET /solve       run the radiosity solver + rebuild CDFs
  GET /filter      apply filter & rebuild CDFs from filtered grids
  GET /rawcdfs     rebuild CDFs from raw radiosity
  GET /pick?u=0.5&v=0.5     primitive under the cursor
  GET /save?path=out.png
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..app import App
from ..utils.config import Config
from ..utils.logger import get_logger
from ..utils.png import png_bytes, write_png

log = get_logger("Viewer")

_PAGE = """<!doctype html>
<html><head><title>tpu_pathtracer</title>
<style>
body{background:#111;color:#ddd;font-family:monospace;margin:12px}
#cols{display:flex;gap:16px;align-items:flex-start}
.panel{background:#1a1a1a;border:1px solid #333;padding:10px;
  border-radius:4px}
.panel h4{margin:2px 0 8px 0;color:#8cf}
img{image-rendering:pixelated;border:1px solid #444}
#frame{cursor:grab;user-select:none;-webkit-user-drag:none}
label{display:flex;align-items:center;gap:6px;margin:3px 0;
  white-space:nowrap}
label span.v{color:#fc6;min-width:4ch;text-align:right}
input[type=range]{width:130px}
input[type=text]{background:#222;color:#ddd;border:1px solid #444;
  width:150px}
select{background:#222;color:#ddd;border:1px solid #444}
button{background:#234;color:#ddd;border:1px solid #456;margin:2px;
  cursor:pointer;border-radius:3px}
button:hover{background:#345}
hr{border-color:#333}
#info{color:#6d6;max-width:340px;white-space:pre-wrap}
.stat{color:#aaa}
</style></head>
<body>
<div id="cols">

<div class="panel">
<h4>frame</h4>
<img id="frame" src="/frame.png" width="512" draggable="false">
<div class="stat" id="renderstat"></div>
<div class="stat">drag: orbit &middot; wheel: zoom &middot;
hover: pick (grid window on)</div>
</div>

<div class="panel" id="controls">
<h4>controls</h4>
<label>Width <input type="range" id="width" min="200" max="2000" step="8">
  <span class="v" id="width_v"></span></label>
<label>Height <input type="range" id="height" min="200" max="2000" step="8">
  <span class="v" id="height_v"></span></label>
<label>SPP <input type="range" id="spp" min="1" max="1000">
  <span class="v" id="spp_v"></span></label>
<label>Scene <select id="scenesel"><option value="">browse…</option>
  </select></label>
<label> <input type="text" id="scene">
  <button onclick="loadScene()">Load</button></label>
<label><input type="checkbox" id="convert_quads">
  Convert Quads to Triangles</label>
<label>Sampling Mode <select id="sampling_mode">
  <option value="bsdf">BSDF Sampling</option>
  <option value="radiosity">Grid Sampling</option>
  <option value="mis">MIS (Mixed)</option>
  <option value="formfactor">FormFactor</option>
  <option value="topk">TopK</option></select></label>
<label id="misrow">BSDF Fraction
  <input type="range" id="mis_bsdf_fraction" min="0" max="1" step="0.01">
  <span class="v" id="mis_bsdf_fraction_v"></span></label>
<label><input type="checkbox" id="nee"> Next-Event Estimation</label>
<label>Integrator <select id="integrator">
  <option value="pt">Path Tracing</option>
  <option value="radiosity">Radiosity</option></select></label>
<hr>
<label>Radiosity Steps
  <input type="range" id="radiosity_iterations" min="0" max="50">
  <span class="v" id="radiosity_iterations_v"></span></label>
<label><input type="checkbox" id="use_monte_carlo"> Use Monte Carlo</label>
<label>MC Samples <input type="range" id="mc_samples" min="4" max="256">
  <span class="v" id="mc_samples_v"></span></label>
<button onclick="go('/solve')">Calculate Radiosity</button>
<hr>
<div>Grid Filtering (16x16 = 256 cells):</div>
<label><input type="checkbox" id="use_bilateral">
  Bilateral (vs Gaussian)</label>
<label>Spatial Sigma
  <input type="range" id="sigma_spatial" min="0.5" max="5" step="0.1">
  <span class="v" id="sigma_spatial_v"></span></label>
<label>Range Sigma
  <input type="range" id="sigma_range" min="0.05" max="1" step="0.05">
  <span class="v" id="sigma_range_v"></span></label>
<button onclick="go('/filter')">Apply Filter &amp; Rebuild CDFs</button>
<button onclick="go('/rawcdfs')">Use Raw CDFs</button>
<hr>
<label>Subdivision <input type="range" id="subdivision" min="0" max="10">
  <span class="v" id="subdivision_v"></span></label>
<label>Save <input type="text" id="savepath" value="out.png">
  <button onclick="savePng()">Save PNG</button></label>
<label><input type="checkbox" id="show_grid" checked>
  Show Grid Window</label>
<hr>
<div>Scene Statistics:</div>
<div class="stat" id="scenestats"></div>
<pre id="info"></pre>
</div>

<div>
<div class="panel" id="gridpanel">
<h4>sampling PDF</h4>
<div class="stat" id="gridmode"></div>
<div class="stat" id="gridsrc"></div>
<div class="stat" id="gridprim">hover over a primitive</div>
<img id="heatmap" src="/heatmap.png?prim=0" width="256">
<div class="stat" id="gridstats"></div>
</div>
<div class="panel">
<h4>profiler</h4>
<div class="stat" id="profstat"></div>
<label><input type="checkbox" id="prof_enable" checked
  onchange="go('/profiler/enable?on='+(this.checked?1:0))">
  Enable Profiling</label>
<button onclick="go('/profiler/reset')">Reset Stats</button>
<img id="prof" src="/profiler.svg">
<hr>
<div>Kernel breakdown (device trace):</div>
<button onclick="kprof()">Sample Kernel Split</button>
<div id="kprofbar" style="display:flex;height:14px;width:260px;
  border:1px solid #444;margin:4px 0"></div>
<div class="stat" id="kproftxt"></div>
</div>
</div>

</div>
<script>
const $=id=>document.getElementById(id);
function go(u){fetch(u).then(r=>r.text()).then(t=>$('info').textContent=t)}
function sendSet(k,v){go('/set?'+k+'='+encodeURIComponent(v))}
function loadScene(){sendSet('scene',$('scene').value)}
function savePng(){go('/save?path='+encodeURIComponent($('savepath').value))}

// Controls-window widgets: sliders show live values, commit on release;
// checkboxes/selects commit on change (reference sliders commit every
// frame; HTTP round-trips make change-commit the equivalent).
const sliders=['width','height','spp','mis_bsdf_fraction',
  'radiosity_iterations','mc_samples','sigma_spatial','sigma_range',
  'subdivision'];
for(const k of sliders){
  $(k).addEventListener('input',()=>{$(k+'_v').textContent=$(k).value});
  $(k).addEventListener('change',()=>sendSet(k,$(k).value));
}
for(const k of ['convert_quads','nee','use_monte_carlo','use_bilateral'])
  $(k).addEventListener('change',()=>sendSet(k,$(k).checked?'1':'0'));
for(const k of ['sampling_mode','integrator'])
  $(k).addEventListener('change',()=>sendSet(k,$(k).value));
$('show_grid').addEventListener('change',()=>{
  $('gridpanel').style.display=$('show_grid').checked?'':'none'});

// Frame interactions (callbacks.h:95-150): drag-orbit at 0.25 deg/px
// with the +/-89 deg pitch clamp applied server-side, wheel zoom at 0.1
// per notch, hover-pick feeding the grid window.
const MOUSE_SENS=0.25, ZOOM_SENS=0.1;
let drag=null, orbitAcc={yaw:0,pitch:0,zoom:0}, orbitTimer=null;
function queueOrbit(dy,dp,dz){
  orbitAcc.yaw+=dy; orbitAcc.pitch+=dp; orbitAcc.zoom+=dz;
  if(!orbitTimer) orbitTimer=setTimeout(()=>{
    const a=orbitAcc; orbitAcc={yaw:0,pitch:0,zoom:0}; orbitTimer=null;
    go('/orbit?yaw='+a.yaw.toFixed(3)+'&pitch='+a.pitch.toFixed(3)
       +'&zoom='+a.zoom.toFixed(3));
  },60);
}
const frame=$('frame');
frame.addEventListener('mousedown',e=>{drag={x:e.clientX,y:e.clientY};
  frame.style.cursor='grabbing';e.preventDefault()});
window.addEventListener('mouseup',()=>{drag=null;
  frame.style.cursor='grab'});
let pickTimer=null;
frame.addEventListener('mousemove',e=>{
  if(drag){
    queueOrbit((e.clientX-drag.x)*MOUSE_SENS,
               (e.clientY-drag.y)*MOUSE_SENS,0);
    drag={x:e.clientX,y:e.clientY};
  } else if($('show_grid').checked && !pickTimer){
    const r=frame.getBoundingClientRect();
    const u=(e.clientX-r.left)/r.width, v=1-(e.clientY-r.top)/r.height;
    pickTimer=setTimeout(()=>{pickTimer=null;
      fetch('/pick?u='+u.toFixed(4)+'&v='+v.toFixed(4))
        .then(r=>r.json()).then(j=>setHovered(j.prim));},120);
  }
});
frame.addEventListener('wheel',e=>{
  queueOrbit(0,0,(e.deltaY>0?1:-1)*ZOOM_SENS);e.preventDefault()});

let hovered=-1;
function setHovered(p){
  if(p===hovered)return; hovered=p;
  if(p<0){$('gridprim').textContent='hover over a primitive';return}
  $('gridprim').textContent='Primitive: '+p;
  $('heatmap').src='/heatmap.png?prim='+p+'&'+Date.now();
  refreshState();
}

// State sync: widget values adopt server state once at load, then only
// labels/stats refresh (so user edits are never clobbered).
let initialized=false;
function refreshState(){
  fetch('/state?prim='+Math.max(hovered,0)).then(r=>r.json()).then(s=>{
    if(!initialized){
      initialized=true;
      for(const k of sliders){
        if(k in s.config){$(k).value=s.config[k];
          $(k+'_v').textContent=$(k).value}}
      for(const k of ['convert_quads','nee','use_monte_carlo',
                      'use_bilateral'])
        if(k in s.config)$(k).checked=s.config[k];
      $('sampling_mode').value=s.config.sampling_mode;
      $('integrator').value=s.config.integrator;
      $('scene').value=s.config.scene;
    }
    $('misrow').style.display=
      s.config.sampling_mode==='mis'?'':'none';
    $('scenestats').textContent='Total Primitives: '+s.scene.num_prims
      +'\\nTriangles: '+s.scene.num_tris+'\\nQuads: '+s.scene.num_quads;
    $('renderstat').textContent=s.render.spp+' spp accumulated | '
      +s.render.mrays.toFixed(1)+' Mrays/s';
    $('gridmode').textContent='Sampling Mode: '+s.config.sampling_mode;
    $('gridsrc').textContent='Source: '+s.grid.source;
    if(hovered>=0) $('gridstats').textContent=
      'Max: '+s.grid.max.toFixed(4)+' | Sum: '+s.grid.sum.toFixed(4)
      +' | Non-zero: '+s.grid.non_zero;
    $('profstat').textContent='FPS: '+s.profiler.fps.toFixed(1)
      +' | Frame: '+s.profiler.frame_ms.toFixed(1)+' ms (avg '
      +s.profiler.avg_frame_ms.toFixed(1)+' ms)';
  });
}
// Scene browser (ImGuiFileDialog parity): dropdown of builtins +
// scenes/ directory; selecting loads immediately.
fetch('/scenes').then(r=>r.json()).then(j=>{
  for(const s of j.scenes){const o=document.createElement('option');
    o.value=s;o.textContent=s;$('scenesel').appendChild(o)}});
$('scenesel').addEventListener('change',()=>{
  if(!$('scenesel').value)return;
  $('scene').value=$('scenesel').value;loadScene()});

// Kernel-phase split (renderProfilerWindow's cycle percentages,
// ui_windows.h:487-550): on-demand — tracing pauses the render loop
// for one step.
const KCOL={intersection:'#d65',rng:'#5ad',grid_sampling:'#da5',
  sort:'#a7d','dma/copy':'#7c7','shading/other':'#999'};
function kprof(){
  $('kproftxt').textContent='tracing one render pass...';
  fetch('/profiler/kernel').then(r=>r.json()).then(p=>{
    const bar=$('kprofbar');bar.innerHTML='';const txt=[];
    for(const k in p.percent){
      const d=document.createElement('div');
      d.style.width=p.percent[k]+'%';d.style.background=KCOL[k]||'#888';
      d.title=k+' '+p.percent[k].toFixed(1)+'%';bar.appendChild(d);
      txt.push(k+' '+p.percent[k].toFixed(1)+'%');
    }
    $('kproftxt').textContent=txt.join(' | ')
      +' | device '+(p.device_total*1e3).toFixed(2)+' ms'
      +' | host syncs '+Object.values(p.host_syncs).reduce((a,b)=>a+b,0)
      +' | rng calls fused '+(p.rng_calls.fused||0)+' eager '
        +(p.rng_calls.eager||0)
      +' | guided sampler fused '+(p.guide_sampler.fused||0)+' eager '
        +(p.guide_sampler.eager||0)
      +(p.lane_occupancy==null?'':' | lanes live '
        +p.lane_occupancy.toFixed(1)+'%')
      +' | iterations replayed '+(p.wavefront_graph.replay||0)+' captured '
        +(p.wavefront_graph.capture||0)+' eager '
        +(p.wavefront_graph.eager||0);
  }).catch(e=>{$('kproftxt').textContent='trace failed: '+e});
}

setInterval(()=>{$('frame').src='/frame.png?'+Date.now();
  $('prof').src='/profiler.svg?'+Date.now();refreshState()},1500);
refreshState();
</script></body></html>"""


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ViewerState:
    """The viewer's App (on `device`) and its render thread, which
    refines the frame continuously while `running` (start(), stop())."""

    def __init__(self, config: Config, device: str | torch.device):
        self.app = App(config, device=device)
        self.app.load_scene()
        self.lock = threading.Lock()
        self.running = True
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.thread.start()

    def stop(self, timeout: float = 60.0) -> bool:
        """End the render loop; True when the thread ended in time."""
        self.running = False
        if self.thread.is_alive():
            self.thread.join(timeout)
        return not self.thread.is_alive()

    def _loop(self):
        """Continuous progressive refinement (renderFrame equivalent),
        feeding the profiler's 120-frame FPS/stage history."""
        while self.running:
            with self.lock:
                prof = self.app.profiler
                prof.begin_frame()
                with prof.stage("Render"):
                    r = self.app.renderer()
                    r.step()
                prof.end_frame()
            # a released Lock goes to no waiter in particular: give the
            # request threads a moment to take it
            time.sleep(0.001)

    def frame_png(self) -> bytes:
        with self.lock:
            r = self.app.renderer()
            img = r.film.to_image()
        return png_bytes(img)

    def apply_settings(self, q: dict) -> set:
        """Apply /set query params to the Config.

        Geometry-affecting keys re-run load_scene() (which also
        invalidates solution/CDFs/renderer), matching the reference
        Controls window's scene/subdivision reload path
        (ui_windows.h:94-104, 213-224). Solver keys invalidate the
        solution so the next prepare() re-solves. Camera keys
        (width/height/fov) rebuild the camera aspect without resetting
        the orbit. Returns the changed key set.
        """
        geo_keys = {"scene", "subdivision", "convert_quads",
                    "pbrt_max_triangles", "mirror_tall_box", "backend"}
        solver_keys = {"radiosity_iterations", "use_monte_carlo",
                       "mc_samples", "radiosity_solver", "ff_estimator",
                       "shooting_steps", "shooters_per_step",
                       "shooting_mc_samples", "grid_refresh",
                       "enable_grid_filtering", "cdf_source", "top_k"}
        cam_keys = {"width", "height", "fov"}
        app = self.app
        with self.lock:
            changed = set()
            for k, v in q.items():
                if hasattr(app.config, k):
                    cur = getattr(app.config, k)
                    new = (
                        v not in ("0", "false", "False")
                        if isinstance(cur, bool)
                        else type(cur)(v)
                    )
                    if new != cur:
                        setattr(app.config, k, new)
                        changed.add(k)
            if changed & geo_keys:
                app.load_scene()
            elif changed:
                if changed & solver_keys:
                    app.solution = None
                    app.cdfs = None
                if changed & cam_keys and app.camera_ctrl is not None:
                    cfg = app.config
                    app.camera_ctrl.aspect = cfg.width / cfg.height
                    app.camera_ctrl.vfov = cfg.fov
                app._renderer = None
        return changed

    # ---- grid-window data (renderGridWindow, ui_windows.h:252-350) ----

    def grid_stats(self, prim: int) -> dict:
        """Hovered primitive's PDF source + max/sum/non-zero stats: the
        FILTERED buffer when one was built (use_filtered), else raw
        radiosity luminance, as in the reference."""
        app = self.app
        with self.lock:
            filtered = app.filtered_radiosity
            if (
                app.config.cdf_source.startswith("filtered")
                and filtered is not None
            ):
                src, buf = "FILTERED PDF", _numpy(filtered)
            elif app.solution is not None:
                from ..core.math_utils import luminance

                src = "RAW Radiosity Grid"
                buf = _numpy(luminance(app.solution.rad_grid))
            else:
                return dict(source="(no solution yet)", max=0.0,
                            sum=0.0, non_zero=0)
            n = buf.shape[0]
            if not 0 <= prim < n:
                return dict(source=src, max=0.0, sum=0.0, non_zero=0)
            g = buf[prim]
            return dict(
                source=src,
                max=float(g.max()),
                sum=float(g.sum()),
                non_zero=int((g > 1e-6).sum()),
            )

    def state_json(self, prim: int = 0) -> str:
        import dataclasses

        app = self.app
        with self.lock:
            cfg = dataclasses.asdict(app.config)
            geom = app.geom
            scene = dict(
                num_prims=geom.num_prims if geom is not None else 0,
                num_tris=geom.num_tris if geom is not None else 0,
                num_quads=(int(geom.is_quad.sum())
                           if geom is not None else 0),
            )
            r = app._renderer
            render = dict(
                spp=int(r.film.spp) if r is not None else 0,
                mrays=float(getattr(r, "mrays_per_sec", 0.0))
                if r is not None else 0.0,
            )
            prof = app.profiler
            frames = list(prof.frame_history)
            profiler = dict(
                fps=prof.fps,
                frame_ms=frames[-1] * 1e3 if frames else 0.0,
                avg_frame_ms=(
                    sum(frames) / len(frames) * 1e3 if frames else 0.0
                ),
                enabled=prof.enabled,
            )
        return json.dumps(dict(
            config=cfg, scene=scene, render=render,
            profiler=profiler, grid=self.grid_stats(prim),
        ))


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, body, ctype="text/plain"):
            if isinstance(body, str):
                body = body.encode()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            url = urllib.parse.urlparse(self.path)
            q = dict(urllib.parse.parse_qsl(url.query))
            app = state.app
            try:
                if url.path == "/":
                    self._send(_PAGE, "text/html")
                elif url.path == "/frame.png":
                    self._send(state.frame_png(), "image/png")
                elif url.path == "/state":
                    self._send(
                        state.state_json(int(q.get("prim", 0))),
                        "application/json",
                    )
                elif url.path == "/heatmap.png":
                    # ?src=radiosity|counts — GridVisualizationMode
                    # parity (RadiosityDistribution vs VisibilityCount,
                    # application_state.h:54-57); ?topk=K overlays the
                    # top-K cells only.
                    from .heatmap import grid_heatmap, top_k_overlay

                    prim = int(q.get("prim", 0))
                    src = q.get("src", "radiosity")
                    topk = int(q.get("topk", 0))
                    with state.lock:
                        if app.cdfs is None:
                            app.precompute_cdfs()
                        if src == "counts":
                            pdf = _numpy(app.solution.grid_counts)
                        else:
                            pdf = _numpy(app.cdfs.pdf)
                    img = (
                        top_k_overlay(pdf, prim, topk)
                        if topk > 0
                        else grid_heatmap(pdf, prim)
                    )
                    self._send(png_bytes(img), "image/png")
                elif url.path == "/profiler":
                    self._send(app.profiler.summary())
                elif url.path == "/profiler.svg":
                    from .profgraph import profiler_svg

                    self._send(profiler_svg(app.profiler),
                               "image/svg+xml")
                elif url.path == "/profiler/kernel":
                    # the phase split of one live render pass (the
                    # reference's in-kernel cycle percentages,
                    # render_config.h:61-77, ui_windows.h:487-550)
                    from ..utils.kernel_profile import (
                        kernel_profile_traced,
                    )

                    with state.lock:
                        r = app.renderer()
                        prof = kernel_profile_traced(
                            lambda: r.step(block=False), device=app.device
                        )
                    self._send(json.dumps(prof), "application/json")
                elif url.path == "/scenes":
                    # Scene browser listing (ImGuiFileDialog parity,
                    # ui_windows.h:88-104): builtins + any .obj/.pbrt
                    # under ./scenes, mouse-loadable via the dropdown.
                    import glob as _glob
                    import os as _os

                    from ..app import _BUILTINS

                    files = sorted(
                        p.replace(_os.sep, "/")
                        for p in _glob.glob(_os.path.join("scenes", "*"))
                        if _os.path.splitext(p)[1].lower()
                        in (".obj", ".pbrt")
                    )
                    self._send(
                        json.dumps({"scenes": list(_BUILTINS) + files}),
                        "application/json",
                    )
                elif url.path == "/profiler/reset":
                    app.profiler.reset()
                    self._send("profiler reset")
                elif url.path == "/profiler/enable":
                    app.profiler.enabled = q.get("on", "1") not in (
                        "0", "false", "False",
                    )
                    self._send(
                        f"profiling {'on' if app.profiler.enabled else 'off'}"
                    )
                elif url.path == "/orbit":
                    with state.lock:
                        app.orbit(
                            float(q.get("yaw", 0)),
                            float(q.get("pitch", 0)),
                            float(q.get("zoom", 0)),
                        )
                    self._send("ok")
                elif url.path == "/set":
                    changed = state.apply_settings(q)
                    self._send(f"set {q} (changed: {sorted(changed)})")
                elif url.path == "/solve":
                    with state.lock:
                        app.run_solver()
                        app.precompute_cdfs()
                    self._send("radiosity solved")
                elif url.path == "/filter":
                    # "Apply Filter & Rebuild CDFs" (ui_windows.h:158-172):
                    # switch to the filtered source and rebuild.
                    with state.lock:
                        app.config.cdf_source = "filtered_radiosity"
                        app.precompute_cdfs()
                        app._renderer = None
                    self._send("filtered CDFs built "
                               "(source=filtered_radiosity)")
                elif url.path == "/rawcdfs":
                    # "Use Raw CDFs" (ui_windows.h:176-183).
                    with state.lock:
                        app.config.cdf_source = "radiosity"
                        app.precompute_cdfs()
                        app._renderer = None
                    self._send("raw CDFs built (source=radiosity)")
                elif url.path == "/pick":
                    with state.lock:
                        idx = app.pick(
                            float(q.get("u", 0.5)), float(q.get("v", 0.5))
                        )
                    self._send(json.dumps({"prim": idx}),
                               "application/json")
                elif url.path == "/save":
                    path = q.get("path", "out.png")
                    with state.lock:
                        r = app.renderer()
                        write_png(path, r.film.to_image())
                    self._send(f"saved {path}")
                else:
                    self.send_error(404)
            except Exception as e:  # noqa: BLE001
                self.send_error(500, str(e))

    return Handler


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="tpu_pathtracer_torch.viewer")
    Config.add_cli_args(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default: cuda)")
    p.add_argument("--port", type=int, default=8000)
    args = p.parse_args(argv)
    cfg = Config.from_cli_args(args)
    cfg.spp = 1 << 30  # progressive forever
    state = ViewerState(cfg, args.device)
    state.start()
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_handler(state))
    log.info("viewer at http://localhost:%d", args.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.stop()
        server.server_close()


if __name__ == "__main__":
    main()
