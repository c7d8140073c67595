"""The seam between the port and its CUDA sources (``ops/_build.py``) on the
CPU: the loader's table of C entries against the ``extern "C"`` declarations
of each source, read as text (no nvcc runs), and the one call's handling of
pointers, streams and error codes, on a stand-in entry."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from tsu_tpu_torch.ops import _build

C_TYPES = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p, "int": ctypes.c_int,
           "unsigned int": ctypes.c_uint, "float": ctypes.c_float, "double": ctypes.c_double,
           "long long": ctypes.c_longlong, "int*": ctypes.POINTER(ctypes.c_int)}


def _extern_c(source: Path) -> dict:
    """{entry: the ctypes of its parameters} of every extern "C" function
    that returns int in ``source``; a ``void* stream`` is a Stream."""
    out = {}
    for entry, params in re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)',
                                    source.read_text()):
        types = []
        for param in params.split(","):
            ctype, name = re.fullmatch(r"(.*?)\s*(\w+)", " ".join(param.split())).groups()
            types.append(_build.Stream if (ctype, name) == ("void*", "stream")
                         else C_TYPES[ctype])
        out[entry] = tuple(types)
    return out


@pytest.mark.parametrize("library", sorted(_build.ENTRIES))
def test_every_entry_of_the_table_is_exported_by_its_source(library):
    """Each entry the loader declares is an extern "C" int function of
    csrc/<library>.cu with as many parameters, of the same types, the
    stream where the source takes one."""
    exported = _extern_c(_build._CSRC / f"{library}.cu")
    for entry, argtypes in _build.ENTRIES[library].items():
        assert entry in exported, (library, entry, sorted(exported))
        assert len(argtypes) == len(exported[entry]), (entry, len(exported[entry]))
        assert argtypes == exported[entry], entry


class _Entry:
    """A stand-in C entry: records its arguments, returns ``err``."""

    def __init__(self, argtypes, err=0):
        self.argtypes, self.err, self.seen, self.__name__ = argtypes, err, [], "tsu_stand_in"

    def __call__(self, *args):
        self.seen.append(args)
        return self.err


def test_call_passes_pointers_null_and_the_stream_and_names_a_failing_entry(monkeypatch):
    """Tensors pass as their data pointers, None as NULL and other values as
    they are, then the stream a loop looked up, or else the device's current
    one; a nonzero return raises RuntimeError naming the entry and the
    error. Device -1 keeps the guard off any card."""
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 99 + index,
                        raising=False)
    t = torch.zeros(4)
    entry = _Entry((_build.P, _build.P, _build.I, _build.F, _build.Stream))
    _build.call(entry, -1, t, None, 7, 0.5, stream=1234)
    _build.call(entry, -1, None, t, True, 1.5)
    assert entry.seen == [(t.data_ptr(), None, 7, 0.5, 1234), (None, t.data_ptr(), True, 1.5, 98)]
    query = _Entry((_build.IP,), err=700)
    with pytest.raises(RuntimeError, match="tsu_stand_in failed with CUDA error 700"):
        _build.call(query, -1, None)
    assert query.seen == [(None,)]


def test_cuda_index_reads_the_device_or_the_current_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert _build.cuda_index(torch.device("cuda", 1)) == 1
    assert _build.cuda_index("cuda:2") == 2
    assert _build.cuda_index("cuda") == 3
