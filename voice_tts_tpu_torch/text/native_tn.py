"""ctypes binding for the native text-normalization core (native/tn_core.cpp).

Builds the shared library on first use (g++, into the package's gitignored
`_build/` directory, beside the CUDA kernels) and falls back silently to the
pure-Python rules in `voice_tts_tpu_torch.text.normalizer` when a toolchain
isn't available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "tn_core.cpp")
_LIB = os.path.join(_PKG, "_build", "libtn_core.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    try:
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", _LIB, _SRC],
                       check=True, capture_output=True, timeout=120)
        return _LIB
    except Exception:  # noqa: BLE001 — toolchain may be absent
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        for name in ("tn_zh_integer", "tn_en_integer"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int]
            fn.restype = ctypes.c_int
        lib.tn_zh_digits.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_int]
        lib.tn_zh_digits.restype = ctypes.c_int
        _lib = lib
        return _lib


_BUF_CAP = 4096


def _call_str(fn, *args) -> Optional[str]:
    buf = ctypes.create_string_buffer(_BUF_CAP)
    n = fn(*args, buf, _BUF_CAP)
    if n < 0:
        return None
    return buf.value.decode("utf-8")


def zh_read_integer(num: int) -> Optional[str]:
    lib = get_lib()
    if lib is None or abs(num) >= 10 ** 16:
        return None
    return _call_str(lib.tn_zh_integer, ctypes.c_longlong(num))


def zh_read_digits(digits: str) -> Optional[str]:
    lib = get_lib()
    if lib is None:
        return None
    return _call_str(lib.tn_zh_digits, digits.encode("ascii", "ignore"))


def en_read_integer(num: int) -> Optional[str]:
    lib = get_lib()
    if lib is None or abs(num) >= 10 ** 12:
        return None
    return _call_str(lib.tn_en_integer, ctypes.c_longlong(num))
