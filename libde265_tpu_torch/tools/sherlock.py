"""sherlock: a stream's structure overlays as one self-contained HTML
file (counterpart of the JAX package's tools/sherlock.py and of
libde265's sherlock265 player): a frame slider and one checkbox per
layer, each layer an RGBA PNG stacked over the decoded picture.

    python -m libde265_tpu_torch.tools.sherlock stream.bin [-o out.html] \
        [-n max_frames] [--layers cb,tb,mv,qp,slice] [--device cuda|cpu]

The stream is decoded through decode_stream_native on `--device`; the
layers come from each picture's decode plan (utils/visualize.py):

  cb    coding-block grid
  tb    transform-block grid
  mv    motion vectors
  qp    QP heat map
  slice per-CTB slice colouring

The PNGs are written by png_bytes (zlib and struct, no imaging
library): the same pixels as the JAX tool's, other bytes.
"""
import argparse
import base64
import json
import os
import struct
import sys
import zlib

import numpy as np


def png_bytes(arr):
    """PNG of an (H, W, 3) RGB or (H, W, 4) RGBA uint8 array: 8 bits a
    sample, every row with filter 0, one zlib IDAT chunk."""
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(arr).reshape(h, w * c)], 1)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         {3: 2, 4: 6}[c], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 9))
            + chunk(b"IEND", b""))


def _png_b64(arr):
    return base64.b64encode(png_bytes(arr)).decode()


def layer_rgba(plan, name):
    """One overlay on a transparent (H, W, 4) uint8 canvas."""
    from ..utils import visualize as V
    H, W = plan.H, plan.W
    rgba = np.zeros((H, W, 4), np.uint8)
    rgb = rgba[..., :3]
    if name == "qp":
        qp = V._expand_plan_grid(plan, plan.qp_y.astype(np.int32))
        heat = np.clip((qp - 20) * 6, 0, 255).astype(np.uint8)
        rgba[..., 0] = heat
        rgba[..., 3] = heat // 2
        return rgba
    if name == "slice":
        sl = np.repeat(np.repeat(plan.slice_addr_rs, 1 << plan.sps.Log2CtbSizeY,
                                 0), 1 << plan.sps.Log2CtbSizeY, 1)[:H, :W]
        pal = np.array([(60, 120, 216), (216, 120, 60), (120, 216, 60),
                        (216, 60, 180), (60, 216, 200), (200, 200, 60)],
                       np.uint8)
        rgba[..., :3] = pal[sl % len(pal)]
        rgba[..., 3] = 56
        return rgba
    before = rgb.copy()
    if name == "cb":
        V.draw_cb_grid(plan, rgb)
    elif name == "tb":
        V.draw_tb_grid(plan, rgb)
    elif name == "mv":
        V.draw_motion(plan, rgb)
    rgba[..., 3] = np.where((rgb != before).any(-1), 230, 0)
    return rgba


HTML = """<!doctype html><meta charset="utf-8">
<title>sherlock — {name}</title>
<style>
 body {{ font: 13px sans-serif; background: #181818; color: #ddd;
        margin: 16px; }}
 #stack {{ position: relative; }}
 #stack img {{ position: absolute; left: 0; top: 0; image-rendering:
              pixelated; width: {dw}px; }}
 #stack img.base {{ position: relative; }}
 label {{ margin-right: 14px; }}
 #bar {{ margin: 8px 0; }}
 input[type=range] {{ width: 420px; vertical-align: middle; }}
</style>
<h3>sherlock — {name} ({w}x{h}, {n} frames)</h3>
<div id="bar">
 frame <input type="range" id="fr" min="0" max="{nm1}" value="0">
 <span id="info"></span><br>
 {boxes}
</div>
<div id="stack"></div>
<script>
const D = {data};
const META = {meta};
const LAYERS = {layers};
const stack = document.getElementById("stack");
function render() {{
  const f = +document.getElementById("fr").value;
  let html = `<img class="base" src="data:image/png;base64,${{D[f].base}}">`;
  for (const l of LAYERS)
    if (document.getElementById("ck_" + l).checked && D[f][l])
      html += `<img src="data:image/png;base64,${{D[f][l]}}">`;
  stack.innerHTML = html;
  const m = META[f];
  document.getElementById("info").textContent =
    ` POC ${{m.poc}} · ${{m.type}} · QP ${{m.qp}} · ${{m.slices}} slice(s)`;
}}
document.getElementById("fr").oninput = render;
for (const l of LAYERS)
  document.getElementById("ck_" + l).onchange = render;
render();
</script>
"""


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sherlock")
    ap.add_argument("stream")
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("-n", "--frames", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--layers", default="cb,tb,mv,qp,slice")
    args = ap.parse_args(argv)

    from ..api import decode_stream_native
    from ..utils.visualize import yuv_to_rgb

    with open(args.stream, "rb") as f:
        data = f.read()
    pics = decode_stream_native(data, device=args.device)
    layers = args.layers.split(",")
    frames, meta = [], []
    ST = {0: "B", 1: "P", 2: "I"}
    for pic in pics[:args.frames]:
        plan = pic.plan
        d = {"base": _png_b64(yuv_to_rgb(pic.planes))}
        hc, wc = pic.planes[0].shape     # conformance-cropped geometry
        for l in layers:
            d[l] = _png_b64(layer_rgba(plan, l)[:hc, :wc])
        frames.append(d)
        sh = plan.slice_headers[0] if plan.slice_headers else None
        meta.append({"poc": plan.poc,
                     "type": ST.get(sh.slice_type, "?") if sh else "?",
                     "qp": sh.SliceQPY if sh else 0,
                     "slices": len(plan.slice_headers)})
    name = os.path.basename(args.stream)
    w, h = (pics[0].plan.W, pics[0].plan.H) if pics else (0, 0)
    boxes = " ".join(
        f'<label><input type="checkbox" id="ck_{l}" '
        f'{"checked" if l in ("cb", "mv") else ""}>{l}</label>'
        for l in layers)
    out = args.out or os.path.splitext(args.stream)[0] + "_sherlock.html"
    with open(out, "w") as f:
        f.write(HTML.format(name=name, w=w, h=h, dw=min(2 * w, 1280),
                            n=len(frames), nm1=max(len(frames) - 1, 0),
                            boxes=boxes, data=json.dumps(frames),
                            meta=json.dumps(meta),
                            layers=json.dumps(layers)))
    print(f"wrote {out} ({os.path.getsize(out)//1024} KiB, "
          f"{len(frames)} frames, layers: {', '.join(layers)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
