"""libde265_tpu_torch: the PyTorch + CUDA port of libde265_tpu's fused
device decode path, for NVIDIA Hopper (sm_90a).

The host side (native parse through native/libhevc_frontend.so, header
parsing, plan packing, the numpy reconstruction of frames the device
program does not take) is a copy of libde265_tpu's JAX-free modules kept
inside this package; the per-frame device program (MC from persistent
tile tables, residuals, intra band scan, deblocking, SAO, DPB insert) is
plain PyTorch around hand-written CUDA kernels (ops/kernels/: MC,
tile-table update, SAO, intra scan). Nothing here imports JAX or
libde265_tpu.

    from libde265_tpu_torch import decode_stream_native, new_decoder
    pics = decode_stream_native(data)              # device="cuda"
    dec = new_decoder()                            # the push API
    dec = new_decoder(parse="python")              # per picture

The names below (those libde265_tpu/__init__.py exports) load at first
use, so importing the package alone (as _build's users do) stays light.
"""
__version__ = "0.1.0"

_API = ("new_decoder", "push_data", "push_nal", "flush_data", "decode",
        "get_next_picture", "decode_stream", "decode_stream_native",
        "DecodedPicture")
__all__ = ["Decoder", "PictureDecoder", *_API]


def __getattr__(name):
    if name in ("Decoder", "PictureDecoder"):
        from . import decoder
        return getattr(decoder, name)
    if name in _API:
        from . import api
        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
