"""Intra-frame parallelism over a list of devices: the 2-D tile mesh demo.

Counterpart of libde265_tpu/parallel/tile_mesh.py, which shards a frame's
columns over a jax.sharding.Mesh and exchanges the seam columns by
all_gather. Here the mesh is a list of torch devices, one column shard
per entry; the list may repeat a device (on one card every shard runs
there, one after another). Each shard

  1. adds the residuals of its batch of TUs (ops/transform.residual_batch)
     to its columns and clips;
  2. smooths its own 8-aligned column boundaries (a structural stand-in
     for vertical deblocking, with the real filter's taps);

then the seams between shards are filtered from one column of each
neighbour, copied device to device (the JAX all_gather + one-hot
select), and a checksum of the filtered plane is summed over the shards
on devices[0] (the JAX psum).

Two choices differ from the JAX function on purpose:
  * TUs that land on the same samples: the JAX scatter leaves the order of
    duplicate indices to XLA. Here the order is fixed: the TUs of a shard
    apply in batch order and the last one wins (each sample takes the
    original plane plus the residual of the last TU that covers it). An
    amax scatter of TU indices finds that TU, whatever order it runs in,
    and each sample then gathers its value, so no sample is written twice
    and the result is the same on every device. (XLA on the CPU gives
    the same on the demo inputs, duplicates included.)
  * The checksum is an int64 sum. The JAX one asks for int64 but runs
    with x64 off, so it is an int32 sum that wraps once the plane's sum
    passes 2^31 (a 4K 10-bit plane can reach ~8.5e9).
"""
import numpy as np
import torch

from ..device import resolve
from ..ops.transform import residual_batch


def _tensor(a, dev):
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(dev, torch.int32).contiguous()


def _local_recon(plane, coeffs, qp, xs, ys, log2, bitdepth):
    """One shard: residuals of its TUs (last one wins on shared samples),
    then the smoothing of its 8-aligned column boundaries."""
    n = 1 << log2
    maxv = (1 << bitdepth) - 1
    h, w = plane.shape
    dev = plane.device
    res = residual_batch(coeffs, qp, log2, False, bitdepth)
    ar = torch.arange(n, device=dev)
    iy = ys.to(torch.int64)[:, None, None] + ar[None, :, None]
    ix = xs.to(torch.int64)[:, None, None] + ar[None, None, :]
    flat = (iy * w + ix).reshape(-1)
    vals = torch.clamp(plane.reshape(-1)[flat] + res.reshape(-1), 0, maxv)
    # the last writer of each sample, in batch order (an amax reduction,
    # which no order of the scatter changes); each sample then gathers
    # its writer's value, so no index is written twice
    last = torch.full((h * w,), -1, dtype=torch.int64, device=dev)
    if flat.numel():
        last.scatter_reduce_(0, flat, torch.arange(flat.numel(),
                                                   device=dev), "amax")
        plane = torch.where(last >= 0, vals[last.clamp(min=0)],
                            plane.reshape(-1)).reshape(h, w)
    else:
        plane = plane.clone()
    # "vertical deblock" inside the shard: every 8-aligned column boundary
    p0 = plane[:, 7::8].clone()
    q0 = plane[:, 8::8].clone() if w > 8 else p0
    m = min(p0.shape[1], q0.shape[1])
    delta = torch.clamp((9 * (q0[:, :m] - p0[:, :m]) + 8) >> 4, -4, 4)
    newp = torch.clamp(p0[:, :m] + delta, 0, maxv)
    newq = torch.clamp(q0[:, :m] - delta, 0, maxv)
    plane[:, 7:7 + 8 * m:8] = newp
    cols = plane[:, 8:8 + 8 * m:8].shape[1]
    plane[:, 8:8 + 8 * m:8] = newq[:, :cols]
    return plane


def make_tile_recon_step(devices, H, W, tiles, n_tu, log2=4, bitdepth=8):
    """Returns step(plane, coeffs, qp, xs, ys) -> (plane, checksum):
    plane (H, W) int32, coeffs (n_tu, n, n) int32, qp, xs, ys (n_tu,)
    int32, numpy arrays or tensors on any device, with xs local to the
    shard. The columns are cut into `tiles` shards of W // tiles, shard d
    on devices[d], and the TUs into `tiles` equal batches in order (batch
    d belongs to shard d). Returns the filtered plane on devices[0] and
    the (1,) int64 checksum of it there."""
    devs = [resolve(d) for d in devices]
    if len(devs) != tiles:
        raise ValueError(f"{len(devs)} devices for {tiles} tiles")
    if W % tiles or n_tu % tiles:
        raise ValueError(f"W {W} and n_tu {n_tu} must be multiples of "
                         f"tiles {tiles}")
    ws, nb = W // tiles, n_tu // tiles
    maxv = (1 << bitdepth) - 1

    def step(plane, coeffs, qp, xs, ys):
        if tuple(plane.shape) != (H, W) or coeffs.shape[0] != n_tu:
            raise ValueError(f"plane {tuple(plane.shape)} / {coeffs.shape[0]}"
                             f" TUs, want ({H}, {W}) / {n_tu}")
        locs = []
        for d, dev in enumerate(devs):
            b = slice(d * nb, (d + 1) * nb)
            locs.append(_local_recon(
                _tensor(plane[:, d * ws:(d + 1) * ws], dev),
                _tensor(coeffs[b], dev), _tensor(qp[b], dev),
                _tensor(xs[b], dev), _tensor(ys[b], dev), log2, bitdepth))
        # halo: each shard's right edge before its left-seam filter, and
        # its left edge before that filter, one H-sample column each
        right = [loc[:, -1].clone() for loc in locs]
        left = [loc[:, 0].clone() for loc in locs]
        for d in range(1, tiles):
            q0 = left[d]
            nbr = right[d - 1].to(devs[d])
            delta = torch.clamp((9 * (q0 - nbr) + 8) >> 4, -4, 4)
            locs[d][:, 0] = torch.clamp(q0 - delta, 0, maxv)
        for d in range(tiles - 1):
            p0 = locs[d][:, -1].clone()
            nbr = left[d + 1].to(devs[d])
            delta = torch.clamp((9 * (nbr - p0) + 8) >> 4, -4, 4)
            locs[d][:, -1] = torch.clamp(p0 + delta, 0, maxv)
        checksum = torch.zeros(1, dtype=torch.int64, device=devs[0])
        for loc in locs:
            checksum += loc.sum(dtype=torch.int64).to(devs[0])
        out = torch.cat([loc.to(devs[0]) for loc in locs], 1)
        return out, checksum

    return step


def demo_inputs(H, W, tiles, n_tu, log2=4, seed=0):
    """The JAX demo's inputs, with the same np.random.RandomState draws."""
    rng = np.random.RandomState(seed)
    n = 1 << log2
    shard_w = W // tiles
    plane = rng.randint(0, 255, (H, W)).astype(np.int32)
    coeffs = rng.randint(-100, 100, (n_tu, n, n)).astype(np.int32)
    qp = np.full((n_tu,), 30, np.int32)
    # per-shard-local x coordinates
    xs = (rng.randint(0, max(1, shard_w // n), (n_tu,)) * n).astype(np.int32)
    ys = (rng.randint(0, max(1, H // n), (n_tu,)) * n).astype(np.int32)
    return plane, coeffs, qp, xs, ys
