"""Copy of libde265_tpu/utils/configparam.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

Typed option registry with automatic command-line generation.

Capability counterpart of the reference's config/parameter system
(libde265/configparam.h:47-110: option_base,
option_bool/int/string/choice, config_parameters with auto-getopt) and the
en265 string-keyed parameter API (en265.h:60-110). Re-designed for Python:
options are declared once, bind to any object with matching attributes
(e.g. encoder.EncoderConfig), and project onto argparse for CLI tools.
"""
import argparse
from dataclasses import dataclass, field
from typing import Any, List


@dataclass
class Option:
    """Base typed option: binds a registry name to a target attribute."""
    name: str                       # CLI/API name, kebab-case
    attr: str                       # attribute on the bound config object
    default: Any = None
    descr: str = ""
    short: str = None               # optional single-letter CLI alias

    def validate(self, v):
        return v

    def parse_string(self, s):
        return self.validate(s)

    def add_to_parser(self, ap: argparse.ArgumentParser):
        names = ["--" + self.name]
        if self.short:
            names.insert(0, "-" + self.short)
        ap.add_argument(*names, dest=self.attr, default=None,
                        help=self.descr or None)


@dataclass
class OptionBool(Option):
    def validate(self, v):
        if isinstance(v, str):
            if v.lower() in ("1", "true", "yes", "on"):
                return True
            if v.lower() in ("0", "false", "no", "off"):
                return False
            raise ValueError(f"{self.name}: not a bool: {v!r}")
        return bool(v)

    def add_to_parser(self, ap):
        names = ["--" + self.name]
        if self.short:
            names.insert(0, "-" + self.short)
        ap.add_argument(*names, dest=self.attr, action="store_true",
                        default=None, help=self.descr or None)


@dataclass
class OptionInt(Option):
    lo: int = None
    hi: int = None

    def validate(self, v):
        v = int(v)
        if self.lo is not None and v < self.lo:
            raise ValueError(f"{self.name}: {v} < min {self.lo}")
        if self.hi is not None and v > self.hi:
            raise ValueError(f"{self.name}: {v} > max {self.hi}")
        return v

    def add_to_parser(self, ap):
        names = ["--" + self.name]
        if self.short:
            names.insert(0, "-" + self.short)
        ap.add_argument(*names, dest=self.attr, type=self.validate,
                        default=None, help=self.descr or None)


@dataclass
class OptionFloat(Option):
    def validate(self, v):
        return float(v)

    def add_to_parser(self, ap):
        names = ["--" + self.name]
        if self.short:
            names.insert(0, "-" + self.short)
        ap.add_argument(*names, dest=self.attr, type=float, default=None,
                        help=self.descr or None)


@dataclass
class OptionString(Option):
    pass


@dataclass
class OptionChoice(Option):
    choices: List[str] = field(default_factory=list)

    def validate(self, v):
        if v not in self.choices:
            raise ValueError(f"{self.name}: {v!r} not in {self.choices}")
        return v

    def add_to_parser(self, ap):
        names = ["--" + self.name]
        if self.short:
            names.insert(0, "-" + self.short)
        ap.add_argument(*names, dest=self.attr, choices=self.choices,
                        default=None, help=self.descr or None)


class ConfigParameters:
    """Option registry bound to nothing; apply to any object whose
    attributes match the options' `attr` names (configparam.h
    config_parameters + register_config_parameters equivalents)."""

    def __init__(self):
        self.options: List[Option] = []
        self._by_name = {}

    def register(self, opt: Option):
        assert opt.name not in self._by_name, opt.name
        self.options.append(opt)
        self._by_name[opt.name] = opt
        return self

    # ---- en265-style string-keyed access (en265.h:60-110)
    def set_value(self, target, name, value):
        opt = self._by_name[name]
        setattr(target, opt.attr, opt.validate(value))

    def get_value(self, target, name):
        return getattr(target, self._by_name[name].attr)

    def param_names(self):
        return [o.name for o in self.options]

    # ---- auto-CLI (configparam.h auto-getopt equivalent)
    def add_to_argparser(self, ap: argparse.ArgumentParser):
        for o in self.options:
            o.add_to_parser(ap)

    def apply_args(self, target, args: argparse.Namespace):
        """Copy every option the user actually set onto target."""
        for o in self.options:
            v = getattr(args, o.attr, None)
            if v is not None:
                setattr(target, o.attr, o.validate(v))

    def dump(self, target):
        return {o.name: getattr(target, o.attr, o.default)
                for o in self.options}


def encoder_parameters() -> ConfigParameters:
    """The registry for encoder.EncoderConfig — the counterpart of the
    reference encoder's registered Algo/core parameters (encoder-core.h
    registerParams + configparam registration)."""
    cp = ConfigParameters()
    cp.register(OptionInt("qp", "qp", 27, "quantization parameter",
                          lo=0, hi=51))
    cp.register(OptionInt("intra-period", "intra_period", 0,
                          "IRAP interval (0: first frame only)", lo=0))
    cp.register(OptionChoice("inter-mode", "inter_mode", "mixed",
                             "fixed-mode cycle for test streams",
                             choices=["skip", "mv", "mixed"]))
    cp.register(OptionBool("rdo", "rdo", False,
                           "RD-optimized mode decision"))
    cp.register(OptionInt("rdo-search-range", "rdo_search_range", 8,
                          "integer-pel motion search range", lo=1, hi=64))
    cp.register(OptionBool("sao", "sao", False, "sample-adaptive offset"))
    cp.register(OptionBool("wpp", "wpp", False,
                           "wavefront parallel processing substreams"))
    cp.register(OptionInt("num-slices", "num_slices", 1,
                          "independent slices per frame", lo=1))
    cp.register(OptionBool("dependent-slices", "dependent_slices", False,
                           "emit slices 2..n as dependent segments"))
    cp.register(OptionBool("b-frames", "b_frames", False,
                           "code inter frames as generalized B"))
    cp.register(OptionInt("num-refs", "num_ref_l0", 1,
                          "active L0 references", lo=1, hi=8))
    cp.register(OptionBool("temporal-mvp", "temporal_mvp", False,
                           "enable TMVP"))
    cp.register(OptionBool("weighted-pred", "weighted_pred", False,
                           "explicit weighted prediction"))
    cp.register(OptionBool("scaling-lists", "scaling_lists", False,
                           "SPS default scaling lists"))
    cp.register(OptionBool("pcm", "pcm", False, "PCM coding of some CUs"))
    cp.register(OptionBool("tq-bypass", "tq_bypass", False,
                           "transquant bypass on some CUs"))
    cp.register(OptionInt("bit-depth", "bit_depth", 8, "8 or 10",
                          lo=8, hi=10))
    cp.register(OptionBool("hash-sei", "write_hash_sei", False,
                           "append decoded-picture-hash SEI"))
    cp.register(OptionFloat("vui-fps", "fps", 0.0,
                            "write VUI timing at this frame rate"))
    cp.register(OptionFloat("bitrate", "bitrate_kbps", 0.0,
                            "target bitrate in kbit/s (rate control)"))
    cp.register(OptionBool("use-cra", "use_cra", False,
                           "non-first intra pictures as CRA"))
    cp.register(OptionBool("temporal-layers", "temporal_layers", False,
                           "odd frames at temporal id 1"))
    return cp
