"""The port's utils/ (quality on tensors, visualize and configparam on
the host) against the JAX package's numpy versions: ssd / sad / mse
exact, psnr / psnr_yuv / ssim within 1e-12 relative, the overlays equal
array for array, and encoder_parameters() filling the port's
EncoderConfig as the JAX registry fills the JAX one."""
import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch

DATA = os.path.join(os.path.dirname(__file__), "data")


def _planes(bd, seed, shape=(72, 104)):
    rng = np.random.RandomState(seed)
    dt = np.uint8 if bd == 8 else np.uint16
    a = rng.randint(0, 1 << bd, shape).astype(dt)
    b = np.clip(a.astype(np.int64) + rng.randint(-9, 10, shape), 0,
                (1 << bd) - 1).astype(dt)
    return a, b


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_quality_matches_jax(bd, as_tensor):
    from libde265_tpu.utils import quality as J
    from libde265_tpu_torch.utils import quality as P
    a, b = _planes(bd, bd)
    x, y = (torch.from_numpy(a.astype(np.int32)),
            torch.from_numpy(b.astype(np.int32))) if as_tensor else (a, b)
    assert P.ssd(x, y) == J.ssd(a, b)
    assert P.sad(x, y) == J.sad(a, b)
    assert P.mse(x, y) == J.mse(a, b)
    mx = (1 << bd) - 1
    assert P.psnr(x, y, mx) == pytest.approx(J.psnr(a, b, mx), rel=1e-12)
    c1, c2 = (0.01 * mx) ** 2, (0.03 * mx) ** 2
    for win in (4, 8):
        assert P.ssim(x, y, c1, c2, win) == pytest.approx(
            J.ssim(a, b, c1, c2, win), rel=1e-12)


def test_psnr_of_equal_planes_is_inf():
    from libde265_tpu_torch.utils import quality as P
    a, _ = _planes(8, 1)
    assert P.psnr(a, a.copy()) == float("inf")
    assert P.psnr(torch.from_numpy(a), torch.from_numpy(a)) == float("inf")
    assert P.ssim(a, a) == pytest.approx(1.0, rel=1e-12)


def test_psnr_yuv_matches_jax():
    from libde265_tpu.utils import quality as J
    from libde265_tpu_torch.utils import quality as P
    w, h = 64, 48
    rng = np.random.RandomState(4)
    ref = rng.randint(0, 256, w * h * 3 // 2).astype(np.uint8)
    planes = [np.clip(p.astype(np.int64) + rng.randint(-5, 6, p.shape), 0,
                      255).astype(np.uint8)
              for p in (ref[:w * h].reshape(h, w),
                        ref[w * h:w * h * 5 // 4].reshape(h // 2, w // 2),
                        ref[w * h * 5 // 4:].reshape(h // 2, w // 2))]
    got = P.psnr_yuv(planes, ref.tobytes(), w, h)
    want = J.psnr_yuv(planes, ref.tobytes(), w, h)
    assert got == pytest.approx([float(v) for v in want], rel=1e-12)


def _decoded(name):
    from libde265_tpu_torch.api import _parse, decode_stream_native
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    return _parse(data), decode_stream_native(data, device="cpu")


@pytest.mark.parametrize("name", ["p_mv", "p_qpdelta", "p_2pu"])
def test_visualize_matches_jax(name):
    from libde265_tpu.utils import visualize as J
    from libde265_tpu_torch.utils import visualize as P
    plans, pics = _decoded(name)
    for plan, pic in zip(plans, pics):
        planes = [np.asarray(p) for p in pic.planes]
        assert np.array_equal(P.yuv_to_rgb(planes), J.yuv_to_rgb(planes))
        for show in (("cb", "tb", "mv"), ("qp",), ("cb", "tb", "mv", "qp")):
            got = P.visualize_frame(plan, planes, show)
            want = J.visualize_frame(plan, planes, show)
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (plan.poc, show)


ARGS = ["--qp", "41", "--sao", "--num-refs", "2", "--inter-mode", "mv",
        "--bit-depth", "10", "--bitrate", "350.5", "--hash-sei",
        "--temporal-layers"]


def test_encoder_parameters_fill_port_config():
    """The same argument list gives the same EncoderConfig fields through
    either registry, and the port's is the port's EncoderConfig."""
    from libde265_tpu.encoder import EncoderConfig as JC
    from libde265_tpu.utils.configparam import encoder_parameters as jp
    from libde265_tpu_torch.encoder import EncoderConfig as PC
    from libde265_tpu_torch.utils.configparam import encoder_parameters as pp
    cfgs = []
    for reg, C in ((pp(), PC), (jp(), JC)):
        ap = argparse.ArgumentParser(add_help=False)
        reg.add_to_argparser(ap)
        cfg = C(width=64, height=64)
        reg.apply_args(cfg, ap.parse_args(ARGS))
        cfg2 = C(width=64, height=64)
        reg.set_value(cfg2, "rdo", "true")
        reg.set_value(cfg2, "qp", "33")
        cfgs.append((dataclasses.asdict(cfg), dataclasses.asdict(cfg2),
                     reg.param_names(), reg.dump(cfg)))
    assert cfgs[0] == cfgs[1]
    assert (cfgs[0][0]["qp"], cfgs[0][0]["num_ref_l0"],
            cfgs[0][0]["bit_depth"]) == (41, 2, 10)


@pytest.mark.parametrize("name,value", [("qp", 99), ("inter-mode", "bogus"),
                                        ("bit-depth", 12), ("sao", "maybe")])
def test_encoder_parameters_reject_like_jax(name, value):
    from libde265_tpu_torch.encoder import EncoderConfig
    from libde265_tpu_torch.utils.configparam import encoder_parameters
    with pytest.raises(ValueError):
        encoder_parameters().set_value(EncoderConfig(), name, value)
