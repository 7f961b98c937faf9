"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/repro_torch/<name>-<hash>.so`` under the checkout's root (``build/``
is git-ignored), with a plain C interface: no PyTorch headers, so a build
takes seconds.  The hash covers the sources and flags, so an edited kernel
is rebuilt and a current one is loaded as it is.  :func:`build_all` starts
one ``nvcc`` per source at once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0 (a launch the card refused never
runs, and a later ``synchronize`` would not report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "flash_decode", "grad_compress",
           "topk_sparsify", "embedding_ops", "fused_adamw",
           "moe_router", "wkv6")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_DECODE_ARGS = ([_P] * 9 + [_I] * 8
                + [ctypes.POINTER(_L), _F, _I, _I, _P, _I, _P])
# C entry point -> (source it is built from, argtypes); see the extern "C"
# blocks in csrc/.  The four decode layouts share one signature.
SIGNATURES: Dict[str, Tuple[str, list]] = {
    "repro_flash_attention": ("flash_attention",
                              [_P] * 4 + [_I] * 7 + [_L] * 12
                              + [_F, _I, _I, _P]),
    "repro_flash_decode": ("flash_decode", _DECODE_ARGS),
    "repro_flash_decode_quant": ("flash_decode", _DECODE_ARGS),
    "repro_flash_decode_paged": ("flash_decode", _DECODE_ARGS),
    "repro_flash_decode_paged_quant": ("flash_decode", _DECODE_ARGS),
    "repro_onebit_quantize": ("grad_compress", [_P] * 3 + [_L, _I, _P]),
    "repro_onebit_dequantize": ("grad_compress",
                                [_P] * 3 + [_I, _L, _I, _P]),
    "repro_topk_sparsify": ("topk_sparsify", [_P] * 3 + [_L, _I, _I, _P]),
    "repro_topk_select": ("topk_sparsify", [_P] * 4 + [_L, _I, _I, _P]),
    "repro_gather_rows": ("embedding_ops", [_P] * 3 + [_L] * 3 + [_P]),
    "repro_scatter_add_rows": ("embedding_ops",
                               [_P] * 3 + [_L, _I, _L, _P]),
    "repro_adamw_update": ("fused_adamw", [_P] * 8 + [_L, _P]),
    "repro_moe_router": ("moe_router", [_P] * 4 + [_L, _I, _I, _P]),
    "repro_moe_route": ("moe_router", [_P] * 10 + [_L] + [_I] * 5 + [_P]),
    "repro_wkv6_chunked": ("wkv6", [_P] * 8 + [ctypes.POINTER(_L), _L]
                           + [_I] * 4 + [_P]),
}

_loaded: Dict[str, ctypes.CDLL] = {}
ptxas_log: Dict[str, str] = {}     # nvcc's -Xptxas -v report per kernel


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME   # torch's own lookup
    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or under CUDA_HOME)")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None when its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    ptxas_log[name] = log
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)       # atomic: a reader never sees half a library


def build_all(names: Sequence[str] = SOURCES) -> None:
    """Compile every kernel that is not built yet, one nvcc each, in
    parallel; waits for all of them."""
    started = {n: _start(n) for n in names}
    errors = []
    for n, s in started.items():
        if s is not None:
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if need be, with
    the argtypes of its entry points declared."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn_name, (src, argtypes) in SIGNATURES.items():
            if src == name:
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def entry(fn_name: str):
    """The C entry point ``fn_name`` (argtypes already declared)."""
    return getattr(load(SIGNATURES[fn_name][0]), fn_name)


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would record a call: the kernels (and their
    wrappers, which fill outputs through raw pointers) have no backward
    yet, so an output would silently carry no gradient.  Raises on the CPU
    too, where the plain version runs, so the CPU tests see what the card
    does."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward pass yet; call it under "
            "torch.no_grad() or on tensors that do not require grad (see "
            "ROADMAP.md)")


def check_dense(name: str, *pairs) -> None:
    """Raise unless each (tensor, dtype) pair is a contiguous CUDA tensor
    of that dtype on the first tensor's device."""
    dev = pairs[0][0].device
    for t, dtype in pairs:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: kernel inputs must be CUDA tensors "
                             "on one device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dtype} tensor, got "
                             f"{t.dtype} with strides {t.stride()}")


def check_inputs(name: str, q, *values, scales=()) -> None:
    """Raise on anything the attention kernels do not take: tensors off q's
    CUDA device, a q dtype other than float32/bfloat16, K/V values of
    another dtype than q's (int8 when ``scales`` are given, and the scales
    float32), a head dim other than 32/64/128, a strided last dim, or value
    rows that do not start 16-byte aligned (K rows are read with 16-byte
    loads).  Scales are read one float at a time through their strides."""
    import torch
    if q.device.type != "cuda":
        raise ValueError(f"{name}: kernel inputs must be CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {q.dtype} (want float32|bfloat16)")
    if q.shape[-1] not in (32, 64, 128):
        raise ValueError(f"{name}: head dim {q.shape[-1]} (want 32|64|128)")
    value_dtype = torch.int8 if scales else q.dtype
    for t in (q, *values):
        if t.device != q.device or t.dtype != (q.dtype if t is q
                                               else value_dtype):
            raise ValueError(f"{name}: inputs differ in device or dtype")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous")
        esz = t.element_size()
        if t.data_ptr() % 16 or any(s * esz % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: rows must start 16-byte aligned")
    for t in scales:
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: scales must be float32 on q's device")
