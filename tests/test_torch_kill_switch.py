"""The filter kill-switches (DE265_DISABLE_DEBLOCK / DE265_DISABLE_SAO,
dec265 --disable-deblocking / --disable-sao) on the port's device
routes: with a switch set, the per-picture push path, the segment push
path and decode_stream_native (the tile-column and GOP decoders among
its routes) give the JAX Decoder's pictures (numpy reconstruction, the
same environment), each frame on its usual route (frame program, hybrid
path, numpy), no SAO stage run while SAO is off; decode_all_pipelined
refuses the switches. Without the repair (device_stream.filter_switches
reading nothing) a stream whose frames take both the numpy route and a
device route differs from the JAX pictures."""
import os

import numpy as np
import pytest

from libde265_tpu.api import get_next_picture as jax_next
from libde265_tpu.decoder import Decoder as JaxDecoder
from libde265_tpu_torch import api
from libde265_tpu_torch import device_stream as DS

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SWITCHES = {"deblock": ("DE265_DISABLE_DEBLOCK",),
            "sao": ("DE265_DISABLE_SAO",),
            "both": ("DE265_DISABLE_DEBLOCK", "DE265_DISABLE_SAO")}
# the frame program (P frames), the hybrid path (every frame), numpy for
# one frame beside the frame program's three
ROUTES = {"p_filters": (0, 0), "rxt_cqo": (0, 4),
          "adv_rot_tsctx_wpp": (1, 0)}


def _data(name):
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        return f.read()


def _jax(data):
    d = JaxDecoder()
    d.push_data(data)
    d.flush()
    while d.decode():
        pass
    out = []
    while (p := jax_next(d)) is not None:
        out.append(p)
    return out


def _same(got, want):
    return len(got) == len(want) and all(
        all(np.array_equal(a, b) for a, b in zip(p.planes, q.planes))
        for p, q in zip(got, want))


def _set(monkeypatch, which):
    for k in ("DE265_DISABLE_DEBLOCK", "DE265_DISABLE_SAO"):
        monkeypatch.delenv(k, raising=False)
    for k in SWITCHES.get(which, ()):
        monkeypatch.setenv(k, "1")


@pytest.mark.parametrize("which", list(SWITCHES))
@pytest.mark.parametrize("name", list(ROUTES))
def test_kill_switch_routes_match_jax(name, which, monkeypatch):
    data = _data(name)
    _set(monkeypatch, None)
    filtered = _jax(data)
    _set(monkeypatch, which)
    want = _jax(data)
    assert not _same(want, filtered)      # the switch changes the stream
    st = {}
    assert _same(api.decode_stream_native(data, device="cpu", stats=st),
                 want)
    assert (st["n_host_frames"], st["n_hybrid_frames"]) == ROUTES[name]
    seg = {}
    assert _same(api.decode_stream(data, device="cpu", stats=seg), want)
    assert seg["n_python_segments"] == 0
    pic = {}
    assert _same(api.decode_stream(data, device="cpu", parse="python",
                                   stats=pic), want)
    assert (pic["n_host_frames"], pic["n_hybrid_frames"]) == ROUTES[name]


@pytest.mark.parametrize("name,kw", [
    ("p_tiles2_mv", dict(tile_devices=["cpu", "cpu"])),
    ("p_filters", dict(gop_devices=["cpu"])),
])
def test_kill_switch_tile_and_gop_decoders(name, kw, monkeypatch):
    data = _data(name)
    _set(monkeypatch, "both")
    want = _jax(data)
    assert _same(api.decode_stream_native(data, device="cpu", **kw), want)


@pytest.mark.parametrize("which", list(SWITCHES))
def test_sao_stage_runs_only_with_sao(which, monkeypatch):
    """The frame program and the hybrid path call K3's wrapper (sao_ctb)
    only while SAO is on; deblocking alone off leaves its calls."""
    from libde265_tpu_torch import frame_program
    from libde265_tpu_torch.ops import filters_fused
    calls = []
    for mod in (frame_program, filters_fused):
        real = mod.sao_ctb
        monkeypatch.setattr(mod, "sao_ctb", lambda *a, _r=real, **k: (
            calls.append(1), _r(*a, **k))[1])
    _set(monkeypatch, which)
    for name in ("p_filters", "rxt_cqo"):
        api.decode_stream_native(_data(name), device="cpu")
    assert (len(calls) == 0) == (which != "deblock")
    _set(monkeypatch, None)
    api.decode_stream_native(_data("rxt_cqo"), device="cpu")
    assert calls


def test_pipelined_refuses_switches(monkeypatch):
    data = _data("p_filters")
    _set(monkeypatch, "sao")
    plans = api._parse(data)
    dec = DS.DeviceStreamDecoder(plans, plans[0].sps, "cpu")
    with pytest.raises(ValueError, match="kill-switches"):
        dec.decode_all_pipelined(keep_outputs=False)
    _set(monkeypatch, None)
    dec = DS.DeviceStreamDecoder(plans, plans[0].sps, "cpu")
    dec.decode_all_pipelined(keep_outputs=False)
    assert dec.n_pipelined_frames == len(plans)


def test_switch_filters_view():
    """switch_filters leaves the plan as it is and returns a view with
    the flags changed; no switch returns the plan itself."""
    plan = api._parse(_data("p_filters"))[1]
    assert DS.switch_filters(plan, (False, False)) is plan
    v = DS.switch_filters(plan, (True, True))
    assert v is not plan and v.slice_headers is not plan.slice_headers
    assert v._pu_arrays[1] is v.slice_headers
    assert v._pu_arrays[0] is plan._pu_arrays[0]
    for sh, o in zip(v.slice_headers, plan.slice_headers):
        assert sh.slice_deblocking_filter_disabled_flag
        assert not (sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag)
        assert o.slice_sao_luma_flag    # the plan's headers kept theirs
    assert not any(o.slice_deblocking_filter_disabled_flag
                   for o in plan.slice_headers)


@pytest.mark.parametrize("which", list(SWITCHES))
def test_fault_without_repair(which, monkeypatch):
    """The fault the repair removes: with the switches read by numpy
    alone, adv_rot_tsctx_wpp's numpy frame is unfiltered and its device
    frames filtered, and the pictures differ from the JAX Decoder's."""
    data = _data("adv_rot_tsctx_wpp")
    _set(monkeypatch, which)
    want = _jax(data)
    monkeypatch.setattr(DS, "filter_switches", lambda: (False, False))
    st = {}
    got = api.decode_stream_native(data, device="cpu", stats=st)
    assert st["n_host_frames"] == 1 and not _same(got, want)
