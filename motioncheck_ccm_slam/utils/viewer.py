"""Viewer-lite: map / trajectory rendering to image files.

Replaces the reference's RViz marker publisher (src/Viewer.cpp — KF frusta,
per-client colored trajectories, covisibility edges, landmark cloud) with
matplotlib exports; the same per-client color table is used
(reference conf/config.yaml:133-176 color blocks).
"""
from __future__ import annotations

import importlib.util
from typing import Dict, Optional

import numpy as np

CLIENT_COLORS = ["#d62728", "#1f77b4", "#2ca02c", "#9467bd"]  # 4 agents


def can_render_png() -> bool:
    """True when matplotlib is installed (the PNG export needs it; the HTML
    export does not)."""
    return importlib.util.find_spec("matplotlib") is not None


def render_map(m, path: str, title: str = "map",
               show_covis: bool = False) -> None:
    """Top-down (x-z) render of a MapState: landmarks + per-client keyframe
    trajectories."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..models import map_state as ms

    fig, ax = plt.subplots(figsize=(9, 6))
    mp_valid = np.asarray(m.mp.valid)
    X = np.asarray(m.mp.Xw)[mp_valid]
    if len(X):
        ax.scatter(X[:, 0], X[:, 2], s=1, c="#999999", alpha=0.5,
                   label=f"{len(X)} landmarks")
    kf_valid = np.asarray(m.kf.valid)
    cids = np.asarray(m.kf.client_id)
    ts = np.asarray(m.kf.timestamp)
    for cid in np.unique(cids[kf_valid]):
        sel = kf_valid & (cids == cid)
        T = np.asarray(m.kf.Tcw)[sel]
        order = np.argsort(ts[sel])
        C = np.stack([np.linalg.inv(t)[:3, 3] for t in T])[order]
        color = CLIENT_COLORS[int(cid) % len(CLIENT_COLORS)]
        ax.plot(C[:, 0], C[:, 2], "o-", ms=3, color=color,
                label=f"agent {cid} ({sel.sum()} KFs)")
    if show_covis:
        W = np.asarray(ms.covisibility(m.kf, m.nm))
        idx = np.argwhere(np.triu(W, 1) >= 15)
        Tall = np.asarray(m.kf.Tcw)
        for a, b in idx:
            if kf_valid[a] and kf_valid[b]:
                Ca = np.linalg.inv(Tall[a])[:3, 3]
                Cb = np.linalg.inv(Tall[b])[:3, 3]
                ax.plot([Ca[0], Cb[0]], [Ca[2], Cb[2]], "-",
                        color="#cccccc", lw=0.3, zorder=0)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.legend(loc="best", fontsize=8)
    ax.set_aspect("equal", adjustable="datalim")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>%TITLE%</title>
<style>body{margin:0;background:#111;color:#ccc;font:12px monospace}
#hud{position:fixed;top:8px;left:8px;user-select:none}
canvas{display:block}</style></head>
<body><div id="hud">%TITLE% &mdash; drag: orbit, wheel: zoom, shift-drag: pan</div>
<canvas id="c"></canvas>
<script>
const DATA = %DATA%;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw = -0.6, pitch = 0.4, dist = DATA.radius * 2.5, cx = DATA.center;
let panX = 0, panY = 0;
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw();}
addEventListener('resize', resize);
let drag=null;
cv.onmousedown=e=>drag={x:e.clientX,y:e.clientY,shift:e.shiftKey};
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
 if(drag.shift){panX+=dx;panY+=dy;}else{yaw+=dx*0.008;pitch+=dy*0.008;
  pitch=Math.max(-1.55,Math.min(1.55,pitch));}
 drag={x:e.clientX,y:e.clientY,shift:drag.shift};draw();});
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault();};
function proj(p){
 const x=p[0]-cx[0], y=p[1]-cx[1], z=p[2]-cx[2];
 const cy_=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
 const x1=cy_*x+sy*z, z1=-sy*x+cy_*z;
 const y2=cp*y-sp*z1, z2=sp*y+cp*z1+dist;
 if(z2<0.05)return null;
 const f=0.9*Math.min(cv.width,cv.height);
 return [cv.width/2+f*x1/z2+panX, cv.height/2+f*y2/z2+panY, z2];
}
function draw(){
 ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
 for(const p of DATA.points){const s=proj(p);if(!s)continue;
  ctx.fillStyle='#8a8a8a';ctx.fillRect(s[0],s[1],1.5,1.5);}
 for(const tr of DATA.trajs){ctx.strokeStyle=tr.color;ctx.lineWidth=1.6;
  ctx.beginPath();let first=true;
  for(const p of tr.pts){const s=proj(p);if(!s){first=true;continue;}
   if(first){ctx.moveTo(s[0],s[1]);first=false;}else ctx.lineTo(s[0],s[1]);}
  ctx.stroke();
  for(const p of tr.pts){const s=proj(p);if(!s)continue;
   ctx.fillStyle=tr.color;ctx.fillRect(s[0]-1.5,s[1]-1.5,3,3);}}
 for(const e of DATA.edges){const a=proj(e[0]),b=proj(e[1]);if(!a||!b)continue;
  ctx.strokeStyle='rgba(180,180,60,0.8)';ctx.lineWidth=1;
  ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();}
}
resize();
</script></body></html>
"""


def map_payload(m) -> dict:
    """Viewer payload of one MapState: landmark cloud, per-client KF
    trajectories, loop edges (the reference Viewer publishes the same three
    marker classes, src/Viewer.cpp)."""
    mp_valid = np.asarray(m.mp.valid)
    X = np.asarray(m.mp.Xw)[mp_valid]
    kf_valid = np.asarray(m.kf.valid)
    cids = np.asarray(m.kf.client_id)
    ts = np.asarray(m.kf.timestamp)
    Tall = np.asarray(m.kf.Tcw)
    centers = np.zeros((len(Tall), 3), np.float32)
    for s in np.flatnonzero(kf_valid):
        centers[s] = np.linalg.inv(Tall[s])[:3, 3]
    trajs = []
    for cid in np.unique(cids[kf_valid]):
        sel = np.flatnonzero(kf_valid & (cids == cid))
        sel = sel[np.argsort(ts[sel])]
        trajs.append({
            "color": CLIENT_COLORS[int(cid) % len(CLIENT_COLORS)],
            "pts": centers[sel].round(4).tolist(),
        })
    edges = []
    loop_e = np.asarray(m.kf.loop_edge)
    for s in np.flatnonzero(kf_valid & (loop_e >= 0)):
        o = int(loop_e[s])
        if kf_valid[o]:
            edges.append([centers[s].round(4).tolist(),
                          centers[o].round(4).tolist()])
    pts = X[:: max(1, len(X) // 20000)]  # cap payload
    allp = np.concatenate([pts, centers[kf_valid]]) if len(pts) else centers[kf_valid]
    center = allp.mean(0) if len(allp) else np.zeros(3)
    radius = float(np.percentile(
        np.linalg.norm(allp - center, axis=-1), 90)) if len(allp) else 1.0
    return {
        "points": pts.round(4).tolist(),
        "trajs": trajs,
        "edges": edges,
        "center": center.round(4).tolist(),
        "radius": max(radius, 1e-3),
    }


def export_html(m, path: str, title: str = "map") -> None:
    """Standalone interactive 3D map viewer (no external deps — a pure-canvas
    orbit renderer). For a LIVE view while the system runs, see
    ``utils.live_viewer.LiveViewer`` (serves the same renderer over HTTP)."""
    import json

    html = (_HTML_TEMPLATE
            .replace("%TITLE%", title)
            .replace("%DATA%", json.dumps(map_payload(m))))
    with open(path, "w") as f:
        f.write(html)


def render_trajectories(trajs: Dict[int, np.ndarray], path: str,
                        gt: Optional[np.ndarray] = None,
                        title: str = "trajectories") -> None:
    """Plot per-agent camera-center tracks (N, 3) plus optional GT."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 6))
    if gt is not None:
        ax.plot(gt[:, 0], gt[:, 2], "k--", lw=1, label="ground truth")
    for cid, C in trajs.items():
        color = CLIENT_COLORS[int(cid) % len(CLIENT_COLORS)]
        ax.plot(C[:, 0], C[:, 2], "-", color=color, label=f"agent {cid}")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.legend(fontsize=8)
    ax.set_aspect("equal", adjustable="datalim")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
