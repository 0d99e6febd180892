"""numpy -> torch for the decoder's state and packed plans.

A decoder has no weights: its state is the DPB stacks (dy/dcb/dcr,
(REF_SLOTS, H, W) int16), the persistent MC tile tables (ty/tc, uint8 for
8-bit) and, per frame, the packed plan dict. These helpers move the JAX
package's numpy arrays onto a torch device with the same shapes and
dtypes, so both packages can be fed identical inputs."""
import numpy as np
import torch

from . import telemetry

_TABLES = {}


def to_tensor(a, device):
    """numpy array (or scalar) -> torch tensor of the same dtype/shape."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a).to(device)


def state_from_numpy(dy, dcb, dcr, ty, tc, device):
    """DPB stacks + tile tables -> a list [dy, dcb, dcr, ty, tc] of
    tensors on `device` (the port mutates it in place)."""
    return [to_tensor(a, device) for a in (dy, dcb, dcr, ty, tc)]


def device_table(name, array, device):
    """The constant numpy table `array` on `device`, uploaded once per
    (name, device). A pageable host-to-device copy synchronises the
    stream, so uploading spec tables every frame would stall the device
    on the host each time."""
    key = (name, torch.device(device))
    t = _TABLES.get(key)
    if t is None:
        t = to_tensor(array, device)
        if t.is_cuda:
            # the table is read on every stream of the device (the GOP
            # decoder runs one per lane): let the copy land first
            torch.cuda.current_stream(t.device).synchronize()
        _TABLES[key] = t
    return t


def plan_from_numpy(t, device):
    """Packed plan dict (packing.pack_frame / frame_program.pack_frame)
    -> dict of tensors on `device`, in a telemetry span "upload" (n:
    bytes)."""
    with telemetry.span("upload", sum(np.asarray(v).nbytes
                                      for v in t.values())):
        return {k: to_tensor(v, device) for k, v in t.items()}
