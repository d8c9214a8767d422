"""The port's one foreign-call path (``kernels/_build.py`` ``call``)
against a fake library, with no nvcc and no card, and every declared C
entry (``_build.ENTRIES``) against its definition in ``kernels/csrc/``."""

import ctypes
import re
import types
from pathlib import Path

import pytest
import torch

from pointnet_like_pose_estimation_tpu_torch.kernels import _build

# the C types of the entries' scalar arguments; every pointer is a c_void_p
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


class FakeEntry:
    """A C entry: records the attributes set on it and every call's
    arguments, and returns ``code``."""

    def __init__(self, code: int):
        object.__setattr__(self, "code", code)
        object.__setattr__(self, "set", [])
        object.__setattr__(self, "calls", [])

    def __setattr__(self, name, value):
        self.set.append(name)
        object.__setattr__(self, name, value)

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


def _fake_library(monkeypatch, code: int):
    """Load ``plpe_fake`` of a library ``fake`` that returns ``code``: the
    library, the paths loaded and the devices whose stream was asked for."""
    lib = types.SimpleNamespace(plpe_fake=FakeEntry(code), plpe_error_string=FakeEntry(b"fake error text"))
    loads, devices = [], []
    monkeypatch.setitem(_build.ENTRIES, "plpe_fake", ("fake", [ctypes.c_void_p] * 2 + [ctypes.c_int]))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build", lambda names: {"fake": _build.Built("fake", Path("fake.so"), 0.0, "")})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loads.append(path) or lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: devices.append(device) or types.SimpleNamespace(cuda_stream=0x5EED))
    return lib, loads, devices


def test_call_sets_the_types_once_and_passes_the_stream_last(monkeypatch):
    lib, loads, devices = _fake_library(monkeypatch, 0)
    x = torch.zeros(4)
    _build.call("plpe_fake", x, None, 7)
    _build.call("plpe_fake", x, None, 8)
    entry = lib.plpe_fake
    assert loads == ["fake.so"] and entry.set == ["argtypes", "restype"]
    assert entry.argtypes == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    assert entry.restype is ctypes.c_int
    assert entry.calls == [(x.data_ptr(), None, 7, 0x5EED), (x.data_ptr(), None, 8, 0x5EED)]
    assert devices == [x.device, x.device]


def test_call_raises_with_the_library_s_error_text(monkeypatch):
    lib, _, _ = _fake_library(monkeypatch, 700)
    with pytest.raises(RuntimeError, match=r"plpe_fake launch failed: CUDA error 700 \(fake error text\)"):
        _build.call("plpe_fake", torch.zeros(1), None, 1)
    assert lib.plpe_error_string.calls == [(700,)]


def _defined_entries() -> dict:
    """Every C entry of ``csrc/*.cu`` that takes a stream last: its library
    and the types of its other arguments."""
    found = {}
    for src in sorted((Path(_build.__file__).parent / "csrc").glob("*.cu")):
        for name, params in re.findall(r"\bint (plpe_\w+)\(([^)]*)\)", src.read_text()):
            params = [" ".join(p.split()) for p in params.split(",")]
            if params[-1] == "void* stream":
                found[name] = (src.stem, [ctypes.c_void_p if "*" in p else C_TYPES[p.rsplit(" ", 1)[0]]
                                          for p in params[:-1]])
    return found


def test_every_entry_is_declared_as_its_source_defines_it():
    defined = _defined_entries()
    assert len(defined) == 11 and _build.ENTRIES == defined
    assert _build.KERNELS == ("fps", "ball_group", "fused_sa", "bn_relu", "knn", "pt_attention")
