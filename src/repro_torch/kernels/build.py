"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared library
with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``, Hopper)
and loaded with ``ctypes``. The build happens once per process, at the
first launch, into ``build/repro_torch/<hash>/`` at the repository root,
where ``<hash>`` is a digest of every source and header, so an edited
source is rebuilt and an unchanged one is reused by later processes; with
``MEMSIM_EXEC_CACHE_DIR`` set, into ``<cache_dir>/<key>/`` instead (the
persistent cache of :mod:`repro_torch.core.exec_cache`). All ``nvcc``
processes start together. A failed build raises. A library that fails to
load is deleted and rebuilt, never served.

``LAUNCHES`` counts the launches of each kernel; a wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"k1": 0, "k2": 0, "k3": 0, "k3run": 0,
                             "k3cyc": 0, "k3batch": 0, "k4": 0, "k5": 0,
                             "k6": 0, "k6gen": 0, "k6gen_tc": 0,
                             "k6bwd": 0, "k6bwd_gen": 0, "k6bwd_gen_tc": 0,
                             "k7": 0, "k7bwd": 0}

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: library -> {C entry point: argtypes}
_ENTRY_POINTS = {
    "bank_fsm": {
        "bank_fsm_step_launch": [_P] * 8 + [_I] * 5 + [_P],
        "bank_event_bound_launch": [_P] * 5 + [_I] * 4 + [_P],
    },
    "fused": {
        "fused_step_launch": [_P] * 9 + [_I] * 12 + [_P],
        "fused_run_launch": [_P] * 2,
        "fused_run_placement_query": [_P],
        "fused_run_args_bytes": [],
        "fused_run_batch_launch": [_P, _P, _I, _P],
        "fused_run_batch_placement_query": [_P, _I],
        "fused_run_batch_occupancy": [_P, _I],
        "fused_run_batch_preload": [],
    },
    "decode_attention": {
        "decode_attention_launch": [_P] * 8 + [_I] * 8 + [_P],
    },
    "flash_attention": {
        "flash_attention_launch": [_P] * 5 + [_I] * 7 + [_P],
        "flash_attention_gen_launch": [_P] * 5 + [_I] * 9
        + [ctypes.c_float, _P],
        "flash_attention_gen_tc_launch": [_P] * 5 + [_I] * 8
        + [ctypes.c_float, _P],
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_launch": [_P] * 10 + [_I] * 7 + [_P],
        "flash_attention_bwd_gen_launch": [_P] * 10 + [_I] * 9
        + [ctypes.c_float, _P],
        "flash_attention_bwd_gen_tc_launch": [_P] * 10 + [_I] * 8
        + [ctypes.c_float, _P],
    },
    "addr_map": {
        "addr_map_launch": [_P] * 6 + [_I] * 12 + [_P],
    },
    "selective_scan": {
        "selective_scan_launch": [_P] * 7 + [_I] * 5 + [_P],
        "selective_scan_config": [_P],
        "selective_scan_sweep_launch": [_P] * 7 + [_I] * 6 + [_P],
        "selective_scan_sweep_configs": [_P, _I],
        "selective_scan_save_launch": [_P] * 8 + [_I] * 6 + [_P],
    },
    "selective_scan_bwd": {
        "selective_scan_bwd_launch": [_P] * 15 + [_I] * 7 + [_P],
        "selective_scan_bwd_config": [_P],
        "selective_scan_bwd_sweep_launch": [_P] * 15 + [_I] * 6 + [_P],
        "selective_scan_bwd_sweep_configs": [_P, _I],
    },
}

#: where ``nvcc`` is looked for when it is not on the PATH
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_build_seconds = [0.0]
_build_count = [0]
#: :func:`load` calls served by the libraries already loaded (hits) and
#: those that went to disk or to nvcc (misses)
_memory = {"hits": 0, "misses": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(CUDA tensors need the CUDA toolkit)")


def build_seconds() -> float:
    """Wall seconds this process spent building (0 when the libraries were
    already on disk)."""
    return _build_seconds[0]


def build_count() -> int:
    """Kernel libraries this process compiled (0 when every library was
    already on disk)."""
    return _build_count[0]


def memory_stats() -> Dict[str, int]:
    """:func:`load` calls served by the libraries this process has loaded
    (``hits``) against those that went to disk or to nvcc (``misses``),
    and the libraries loaded (``entries``)."""
    with _lock:
        return dict(_memory, entries=len(_libs))


def build_dir() -> Path:
    """Where :func:`load` builds and loads the libraries:
    ``<cache_dir>/<key>/`` with ``MEMSIM_EXEC_CACHE_DIR`` set, else
    ``build/repro_torch/<source hash>/``."""
    from repro_torch.core import exec_cache

    d = exec_cache.cache_dir()
    if d is None:
        return BUILD_ROOT / source_hash()
    return Path(d) / exec_cache.make_key("kernels")


def _open(path: Path, name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _ENTRY_POINTS[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def load() -> Dict[str, ctypes.CDLL]:
    """The loaded kernel libraries, building first the ones not on disk
    (or that fail to load: they are deleted and rebuilt)."""
    from repro_torch.core import exec_cache

    with _lock:
        if _libs:
            _memory["hits"] += 1
            return _libs
        _memory["misses"] += 1
        cached = exec_cache.cache_dir() is not None
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        libs, todo = {}, []
        t0 = time.perf_counter()
        for name in _ENTRY_POINTS:
            path = out_dir / f"lib{name}.so"
            if not path.exists():
                todo.append(name)
                continue
            try:
                libs[name] = _open(path, name)
            except (OSError, AttributeError):
                path.unlink(missing_ok=True)
                todo.append(name)
                if cached:
                    exec_cache.count("errors")
        if cached:
            exec_cache.count("hits", len(libs))
            exec_cache.count("misses", len(todo))
            exec_cache.count("load_s", time.perf_counter() - t0)
        t0 = time.perf_counter()
        nvcc = _nvcc() if todo else None
        procs = {}
        for name in todo:
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            with open(out_dir / f"{name}.log", "w") as log:
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT), tmp)
        # wait for every compiler before reporting any failure
        codes = {name: proc.wait() for name, (proc, _) in procs.items()}
        for name, rc in codes.items():
            if rc != 0:
                raise RuntimeError(
                    f"nvcc failed on csrc/{name}.cu (exit {rc}):\n"
                    + (out_dir / f"{name}.log").read_text())
            os.replace(procs[name][1], out_dir / f"lib{name}.so")
        if procs:
            _build_seconds[0] += time.perf_counter() - t0
            _build_count[0] += len(procs)
            if cached:
                exec_cache.count("writes", len(procs))
        for name in todo:
            libs[name] = _open(out_dir / f"lib{name}.so", name)
        _libs.update((name, libs[name]) for name in _ENTRY_POINTS)
        return _libs


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def refuse_grad(name: str, **tensors) -> None:
    """Raise when grad mode is on and an input requires grad: a kernel
    whose output is filled through a raw pointer has no ``grad_fn``, so
    its output would be silently detached from the graph."""
    import torch

    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors.values()):
        raise RuntimeError(
            f"{name}: an input requires grad, and this kernel has no "
            f"backward here; its output would be detached from the graph "
            f"(run it under torch.no_grad(), or through an op with a "
            f"backward)")


def require_cuda(name: str, dtype=None, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``
    (int32 when not given) on the current device."""
    import torch

    dtype = torch.int32 if dtype is None else dtype
    dev = None
    for k, t in tensors.items():
        if not (isinstance(t, torch.Tensor) and t.is_cuda):
            raise ValueError(f"{name}: {k} must be a CUDA tensor")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {k} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {k} is on {t.device}, not {dev}")
    if dev is not None and dev.index not in (None,
                                             torch.cuda.current_device()):
        raise ValueError(f"{name}: tensors on {dev} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")
