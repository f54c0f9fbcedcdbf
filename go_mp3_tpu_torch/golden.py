"""The golden backend's oracle, reached without JAX.

go_mp3_tpu/ops/reference_dsp.py is the JAX package's numpy float64 golden
decoder (GoldenDecoder). It needs only numpy, go_mp3_tpu.consts,
go_mp3_tpu.bitstream and its sibling ops/tables.py (with
ops/synth_window_data.py), but it can be imported only through
go_mp3_tpu/ops/__init__.py, which imports JAX.

golden_decoder_class() loads those three files by path, as modules of a
private package (_go_mp3_tpu_golden.ops), whose `consts` and `bitstream`
are the already-imported go_mp3_tpu modules: FrameHeader, SideInfo and
MainData are the very classes the parser returns, and nothing is
registered under go_mp3_tpu.ops. The oracle's code is not copied.
"""

from __future__ import annotations

import importlib
import sys
import types
from pathlib import Path

import go_mp3_tpu
import go_mp3_tpu.bitstream
import go_mp3_tpu.bitstream.frameheader
import go_mp3_tpu.bitstream.maindata
import go_mp3_tpu.bitstream.sideinfo
import go_mp3_tpu.consts

_PKG = "_go_mp3_tpu_golden"
_OPS_DIR = Path(go_mp3_tpu.__file__).resolve().parent / "ops"
_ALIASES = ("consts", "bitstream", "bitstream.frameheader",
            "bitstream.maindata", "bitstream.sideinfo")


def golden_decoder_class() -> type:
    """go_mp3_tpu.ops.reference_dsp.GoldenDecoder, loaded (once per
    process) without go_mp3_tpu.ops and without JAX."""
    name = f"{_PKG}.ops.reference_dsp"
    if name not in sys.modules:
        root = types.ModuleType(_PKG)
        root.__path__ = []  # a package whose submodules are all set below
        ops = types.ModuleType(f"{_PKG}.ops")
        ops.__path__ = [str(_OPS_DIR)]  # tables.py etc. by path; no __init__
        sys.modules[_PKG] = root
        for alias in _ALIASES:
            sys.modules[f"{_PKG}.{alias}"] = sys.modules[f"go_mp3_tpu.{alias}"]
        sys.modules[ops.__name__] = ops
        importlib.import_module(name)
    return sys.modules[name].GoldenDecoder
