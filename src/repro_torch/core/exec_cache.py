"""Persistent on-disk cache of the port's compiled kernels.

PyTorch counterpart of ``repro.core.exec_cache``. The port compiles no
program a topology: what a process compiles is the set of nvcc libraries,
one a ``csrc/*.cu`` file (:mod:`repro_torch.kernels.build`). This module
makes that build persistent on the reference's terms: with
``MEMSIM_EXEC_CACHE_DIR`` set, :func:`repro_torch.kernels.build.load`
builds into, and loads from, ``<cache_dir>/<key>/``, so a fresh process
over a warm directory loads every library and runs ``nvcc`` zero times.

Keying / invalidation: an entry's key is the SHA-256 of

    (ENGINE_ABI_VERSION, torch version, torch's CUDA version, nvcc flags,
     the digest of every kernel source and header, runner name, static
     key, shapes)

so an edited source, other flags, another PyTorch build or an ABI bump
(``ENGINE_ABI_VERSION`` must be raised whenever a kernel's semantics change
in a way the sources do not show) misses cleanly and rebuilds. The key
needs no ``nvcc``: a warm process never calls it. Deleting any or all
entries is always safe.

Storage contract:
  * enabled iff ``MEMSIM_EXEC_CACHE_DIR`` is set (non-empty) and no
    :func:`disabled` block is open; unset, the build stays in
    ``build/repro_torch/<hash>/`` at the repository root;
  * each library is published atomically (temp name + ``os.replace``), so
    a killed build never publishes a torn file;
  * a library that fails to load counts as an error, is deleted and is
    rebuilt: it is never served.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import threading
from typing import Dict, Optional

#: Bump whenever a kernel's semantics change in a way its source digest
#: does not capture. Part of every cache key and of the streaming sweeps'
#: fingerprints (the reference's value, so their manifests agree).
ENGINE_ABI_VERSION = 2  # 2: tier-major packed schedule rows ([T*S, NP])

_lock = threading.Lock()
_stats: Dict[str, float] = {"hits": 0, "misses": 0, "writes": 0,
                            "errors": 0, "load_s": 0.0}
_disabled_depth = 0


def cache_dir() -> Optional[str]:
    """The persistent cache directory, or None when the cache is off.

    Re-read from ``MEMSIM_EXEC_CACHE_DIR`` on every call; an unset or
    empty variable (or an open :func:`disabled` block) turns it off."""
    if _disabled_depth > 0:
        return None
    d = os.environ.get("MEMSIM_EXEC_CACHE_DIR", "").strip()
    return d or None


@contextlib.contextmanager
def disabled():
    """Context manager: ignore the persistent cache (neither load nor
    store) for the duration; it wins over the variable."""
    global _disabled_depth
    with _lock:
        _disabled_depth += 1
    try:
        yield
    finally:
        with _lock:
            _disabled_depth -= 1


def make_key(name: str, static_key: tuple = (), shapes: tuple = ()) -> str:
    """Stable cross-process cache key (hex SHA-256) of the runner ``name``
    with its ``static_key`` and ``shapes`` (deterministic ``repr``s), over
    the PyTorch build, the nvcc flags and the kernel sources."""
    import torch

    from repro_torch.kernels import build

    material = repr((
        ENGINE_ABI_VERSION,
        torch.__version__,
        torch.version.cuda,
        tuple(build.NVCC_FLAGS),
        build.source_hash(),
        name,
        static_key,
        shapes,
    ))
    return hashlib.sha256(material.encode()).hexdigest()


def count(key: str, n: float = 1) -> None:
    """Add ``n`` to the lifetime counter ``key`` (``hits``, ``misses``,
    ``writes``, ``errors`` or ``load_s``)."""
    with _lock:
        _stats[key] += n


def _entries(d: str) -> int:
    return sum(1 for sub in os.listdir(d)
               if os.path.isdir(os.path.join(d, sub))
               for fn in os.listdir(os.path.join(d, sub))
               if fn.startswith("lib") and fn.endswith(".so"))


def clear() -> int:
    """Remove every cache entry (a key directory and the libraries in it)
    from the cache directory. Returns the number of libraries removed; a
    no-op when the variable is unset."""
    d = os.environ.get("MEMSIM_EXEC_CACHE_DIR", "").strip()
    if not d or not os.path.isdir(d):
        return 0
    removed = _entries(d)
    for sub in os.listdir(d):
        path = os.path.join(d, sub)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
    return removed


def stats() -> Dict:
    """Lifetime counters of this process: ``hits`` (libraries loaded from
    the cache), ``misses`` (libraries it had to build), ``writes``
    (libraries published), ``errors`` (libraries that failed to load and
    were deleted), the cumulative load wall ``load_s``, ``enabled`` and
    the libraries on disk (``entries``)."""
    with _lock:
        out = dict(_stats)
    out["load_s"] = round(out["load_s"], 4)
    d = os.environ.get("MEMSIM_EXEC_CACHE_DIR", "").strip()
    out["enabled"] = bool(d)
    out["entries"] = _entries(d) if d and os.path.isdir(d) else 0
    return out
