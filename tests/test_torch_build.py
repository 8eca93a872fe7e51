"""The C interface of the port's CUDA library against its ctypes bindings.

``ops/kernels/build.py`` loads ``csrc/*.cu`` as one shared library and gives
every ``extern "C"`` entry point the argtypes of ``build.SIGNATURES``. A
binding that drifts from its C signature passes a pointer as a 32-bit int, or
shifts every argument after the drift, and nothing on the CPU calls the
library. So these tests parse the sources: each entry point's parameters,
in order, must be the binding's pointer, int, float and int64 types.
"""
import ctypes
import re

import pytest

from vil_tpu_torch.ops.kernels import build

_ENTRY = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _ctype(param: str):
    """The ctypes type that passes one C parameter (its declaration)."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    kind = decl.rsplit(" ", 1)[0]  # the type without the parameter's name
    types = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_int64,
             "int64_t": ctypes.c_int64}
    if kind not in types:
        raise AssertionError(f"no ctypes binding for the C parameter {decl!r}")
    return types[kind]


def _entries() -> dict:
    """{name: (return type, [ctypes type of each parameter])} of every
    extern "C" function of csrc/*.cu."""
    found = {}
    for src in build._sources():
        for ret, name, params in _ENTRY.findall(src.read_text()):
            assert name not in found, f"{name} defined twice"
            found[name] = (" ".join(ret.split()),
                           [_ctype(p) for p in params.split(",") if p.strip()])
    return found


def test_every_entry_point_has_a_binding():
    """The library's entry points are those of SIGNATURES, plus the error
    string."""
    assert set(_entries()) == set(build.SIGNATURES) | {"vil_cuda_error_string"}


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_entry_point_signature_matches_its_argtypes(name):
    ret, params = _entries()[name]
    assert ret == "int", (name, ret)  # the launch's cudaError_t
    assert params == build.SIGNATURES[name], name


def test_error_string_signature():
    ret, params = _entries()["vil_cuda_error_string"]
    assert ret == "const char*" and params == [ctypes.c_int]

