"""The ctypes bindings of the CUDA kernels match their C prototypes.

``repro_torch.kernels._build.SIGNATURES`` declares the argtypes of every
``extern "C"`` entry point under ``src/repro_torch/kernels/csrc``.  A
mismatch is silent on the card: ctypes passes an undeclared pointer as a
32-bit int and cuts it, or shifts every argument after a missing one.  The
kernels cannot be built here, so these tests read the prototypes from the
sources and hold the declarations to them.
"""
import ctypes
import pathlib
import re

import pytest

from repro_torch.kernels import _build

CSRC = pathlib.Path(_build.CSRC)
PROTO = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')
DEFINE = re.compile(r"#define\s+(\w+)\(\s*(\w+)")
# C parameter type -> the ctypes type its argtypes entry must be
C_TYPES = {
    "void*": ctypes.c_void_p,
    "const void*": ctypes.c_void_p,
    "int": ctypes.c_int,
    "long long": ctypes.c_longlong,
    "float": ctypes.c_float,
    "const long long*": ctypes.POINTER(ctypes.c_longlong),
}


def _param_type(param: str) -> str:
    """``const long long* strides`` -> ``const long long*``."""
    param = " ".join(param.split())
    name = re.search(r"\w+$", param)
    return param[:name.start()].strip().replace(" *", "*")


def c_prototypes():
    """Entry point -> (source stem, [C parameter types]), for every
    ``extern "C" int repro_*(...)`` in csrc.  A prototype inside a
    ``#define`` whose first parameter names the function stands for each
    entry point the macro is invoked with."""
    protos = {}
    for path in sorted(CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text()).replace("\\\n", " ")
        for m in PROTO.finditer(text):
            name = m.group(1)
            types = [_param_type(p) for p in m.group(2).split(",")]
            if name.startswith("repro_"):
                protos[name] = (path.stem, types)
                continue
            macros = [d.group(1) for d in DEFINE.finditer(text, 0, m.start())
                      if d.group(2) == name]
            assert macros, f"{path.name}: {name}(...) is not a repro_ entry"
            for inv in re.finditer(rf"^{macros[-1]}\((\w+)", text, re.M):
                protos[inv.group(1)] = (path.stem, types)
    return protos


PROTOS = c_prototypes()


def test_every_entry_point_is_declared():
    assert len(PROTOS) >= 13
    assert set(PROTOS) == set(_build.SIGNATURES)


def test_sources_list_every_csrc_file():
    assert set(_build.SOURCES) == {p.stem for p in CSRC.glob("*.cu")}


def test_every_c_parameter_type_is_known():
    unknown = {t for _, types in PROTOS.values() for t in types
               if t not in C_TYPES}
    assert not unknown


@pytest.mark.parametrize("entry", sorted(_build.SIGNATURES))
def test_argtypes_match_the_c_prototype(entry):
    source, argtypes = _build.SIGNATURES[entry]
    c_source, c_types = PROTOS[entry]
    assert source == c_source
    assert len(argtypes) == len(c_types)
    for i, (got, c_type) in enumerate(zip(argtypes, c_types)):
        assert got is C_TYPES[c_type], (
            f"{entry} argument {i}: {c_type} is declared {got}")
