"""Copy of libde265_tpu/utils/visualize.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

Bitstream-structure visualization overlays (counterpart of
libde265/visualize.{h,cc} used by sherlock265): draws CB/TB/PB
grids, intra-mode arrows, QP maps and motion vectors onto RGB arrays."""
import numpy as np


def _expand_plan_grid(plan, grid4):
    return np.repeat(np.repeat(grid4, 4, 0), 4, 1)[:plan.H, :plan.W]


def draw_cb_grid(plan, rgb, color=(0, 0, 255)):
    for bit, axis in ((1, 1), (2, 0)):
        mask4 = (plan.cb_boundary & bit) > 0
        mask = _expand_plan_grid(plan, mask4)
        if bit == 1:
            edge = np.zeros_like(mask)
            edge[:, ::4] = mask[:, ::4]
            sel = np.zeros_like(mask); sel[:, :] = False
            sel[:, np.arange(0, plan.W, 4)] = True
            m = mask & sel
        else:
            m = np.zeros_like(mask)
            m[np.arange(0, plan.H, 4), :] = mask[np.arange(0, plan.H, 4), :]
        rgb[m] = color
    return rgb


def draw_tb_grid(plan, rgb, color=(0, 255, 0)):
    mask4 = (plan.tu_boundary > 0)
    mask = _expand_plan_grid(plan, mask4)
    m = np.zeros_like(mask)
    m[:, np.arange(0, plan.W, 4)] = mask[:, np.arange(0, plan.W, 4)]
    rgb[m] = color
    return rgb


def draw_qp_map(plan, rgb):
    qp = _expand_plan_grid(plan, plan.qp_y.astype(np.int32))
    heat = np.clip((qp - 20) * 6, 0, 255).astype(np.uint8)
    rgb[..., 0] = np.maximum(rgb[..., 0], heat)
    return rgb


def draw_motion(plan, rgb, color=(255, 255, 0)):
    for pu in plan.pus:
        if not (pu.pred_flag[0] or pu.pred_flag[1]):
            continue
        cx, cy = pu.x + pu.w // 2, pu.y + pu.h // 2
        l = 0 if pu.pred_flag[0] else 1
        ex = int(np.clip(cx + pu.mv[l][0] / 4, 0, plan.W - 1))
        ey = int(np.clip(cy + pu.mv[l][1] / 4, 0, plan.H - 1))
        n = max(abs(ex - cx), abs(ey - cy), 1)
        xs = np.linspace(cx, ex, n * 2).astype(int)
        ys = np.linspace(cy, ey, n * 2).astype(int)
        rgb[np.clip(ys, 0, plan.H - 1), np.clip(xs, 0, plan.W - 1)] = color
    return rgb


def yuv_to_rgb(planes):
    y = planes[0].astype(np.float32)
    u = np.repeat(np.repeat(planes[1], 2, 0), 2, 1).astype(np.float32) - 128
    v = np.repeat(np.repeat(planes[2], 2, 0), 2, 1).astype(np.float32) - 128
    u = u[:y.shape[0], :y.shape[1]]; v = v[:y.shape[0], :y.shape[1]]
    r = y + 1.402 * v
    g = y - 0.344 * u - 0.714 * v
    b = y + 1.772 * u
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def visualize_frame(plan, planes, show=("cb", "tb", "mv")):
    rgb = yuv_to_rgb(planes)
    if "qp" in show:
        draw_qp_map(plan, rgb)
    if "cb" in show:
        draw_cb_grid(plan, rgb)
    if "tb" in show:
        draw_tb_grid(plan, rgb)
    if "mv" in show:
        draw_motion(plan, rgb)
    return rgb
