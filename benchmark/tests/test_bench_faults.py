"""The comparison that decides `correct` can fail: the control and the
faults a cell of this benchmark can have, each planted in the timed path
underneath a run on device="cpu" (the harness's look for a card left
out), each seen to make `correct` false. The fault of the exchange
between cards does not apply: both cells run on one card.

The control is the program's own kill-switch DE265_DISABLE_DEBLOCK
(dec265 --disable-deblocking): pictures without the deblocking the
stream asks for, the step a later change might be tempted to skip. On
the card it runs at the cells' own sizes with `--control deblock_off`.
"""
import pytest

from benchmark import check, run as bench_run
from bench_cells import ROOT, small_cell

MIXES = ("transcode", "keyframes")


def _run(cell):
    run, checks, att, failed, _ = bench_run.run_cell(ROOT, cell, 2 ** 33,
                                                     1.0, 0, "cpu")
    return run, checks, att, failed


@pytest.mark.parametrize("mix", MIXES)
def test_sound_run_is_correct(mix):
    run, checks, att, failed = _run(small_cell("p_deblk", mix=mix))
    assert check.correct(checks, att) and failed == 0


@pytest.mark.parametrize("mix", MIXES)
def test_control_deblocking_off(mix, monkeypatch):
    monkeypatch.setenv("DE265_DISABLE_DEBLOCK", "1")
    run, checks, att, failed = _run(small_cell("p_deblk", mix=mix))
    assert not check.correct(checks, att)
    assert checks["planes_wrong"] > 0 and failed > 0


@pytest.mark.parametrize("mix", MIXES)
def test_state_left_unchanged(mix, monkeypatch):
    """The frame program's step returns without touching the DPB: each
    picture reads whatever its slot held before."""
    from libde265_tpu_torch import device_stream
    monkeypatch.setattr(device_stream, "decode_frame_device",
                        lambda *a, **kw: None)
    run, checks, att, failed = _run(small_cell("p_mv", mix=mix))
    assert not check.correct(checks, att) and checks["planes_wrong"] > 0


@pytest.mark.parametrize("mix", MIXES)
def test_half_the_pictures_left_out(mix, monkeypatch):
    from libde265_tpu_torch import api
    orig, n = api.get_next_picture, [0]

    def every_other(dec):
        while True:
            pic = orig(dec)
            if pic is None:
                return None
            n[0] += 1
            if n[0] % 2:
                return pic

    monkeypatch.setattr(api, "get_next_picture", every_other)
    run, checks, att, failed = _run(small_cell("p_mv", mix=mix))
    assert not check.correct(checks, att)
    assert checks["pictures_missing"] > 0


@pytest.mark.parametrize("mix", MIXES)
def test_one_sample_altered(mix, monkeypatch):
    """One sample of each downloaded picture changed where the decoder
    produces it."""
    from libde265_tpu_torch.device_stream import DeviceStreamDecoder
    orig = DeviceStreamDecoder.planes_of

    def altered(self, fid):
        planes = [p.copy() for p in orig(self, fid)]
        planes[0][3, 5] ^= 1
        return planes

    monkeypatch.setattr(DeviceStreamDecoder, "planes_of", altered)
    run, checks, att, failed = _run(small_cell("p_mv", mix=mix))
    assert not check.correct(checks, att)
    assert checks["planes_wrong"] == len(run.pictures) == failed


def test_a_request_that_raises(monkeypatch):
    from libde265_tpu_torch import api
    orig, n = api._decode_plans, [0]

    def fails_later(*a, **kw):
        n[0] += 1
        if n[0] > 3:
            raise RuntimeError("planted device error")
        return orig(*a, **kw)

    monkeypatch.setattr(api, "_decode_plans", fails_later)
    run, checks, att, failed = _run(small_cell("p_mv", mix="keyframes"))
    assert not check.correct(checks, att)
    assert checks["requests_failed"] > 0
    assert checks["pictures_missing"] == checks["requests_failed"]
