"""Checkpoint/restart with atomic commit and async snapshot, and the
chunk store of the streaming sweeps.

PyTorch counterpart of ``repro.checkpoint.store``, in its file format:
a checkpoint written by either package restores in the other.

Layout per step::

    <dir>/step_000123/
        manifest.json     # step, leaf counts, extra
        shard_h000.npz    # this host's arrays (flattened tree -> npz keys)
    <dir>/LATEST          # atomically renamed pointer file (commit point)

A tree is nested dicts, lists and tuples (named tuples too) whose leaves
are tensors or arrays; it is flattened in ``jax.tree_util``'s order (dict
keys sorted, ``None`` holds no leaf), so the ``p_leaf_00000...`` keys name
the same leaves as the reference's.

Fault-tolerance contract:
  * a checkpoint is visible only after its LATEST pointer is renamed in
    (crash mid-write leaves the previous checkpoint intact);
  * ``save_async`` snapshots host arrays synchronously (cheap) and writes
    in a background thread so the train loop continues;
  * ``restore`` places each leaf on its template's device in its dtype
    and refuses a leaf whose shape differs from its template's.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Any) -> Tuple[List[Any], Any]:
    """The leaves of ``tree`` in ``jax.tree_util`` order, and its
    structure for :func:`_unflatten`."""
    leaves: List[Any] = []

    def walk(x):
        if x is None:
            return ("none",)
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", type(x), keys, [walk(x[k]) for k in keys])
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return ("namedtuple", type(x), [walk(v) for v in x])
        if isinstance(x, (list, tuple)):
            return ("seq", type(x), [walk(v) for v in x])
        leaves.append(x)
        return ("leaf",)

    return leaves, walk(tree)


def _unflatten(spec: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(sp):
        kind = sp[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return sp[1]((k, build(s)) for k, s in zip(sp[2], sp[3]))
        if kind == "namedtuple":
            return sp[1](*[build(s) for s in sp[2]])
        return sp[1](build(s) for s in sp[2])

    return build(spec)


def _to_host(x: Any) -> np.ndarray:
    """A leaf as a host array; bfloat16, which numpy lacks, widens
    losslessly to float32 (``restore`` casts back to the template's)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _host_tree(tree: Any) -> Any:
    leaves, spec = _flatten(tree)
    return _unflatten(spec, [_to_host(x) for x in leaves])


def _like(arr: np.ndarray, template: Any) -> Any:
    """``arr`` as the template leaf's kind: a tensor on its device in its
    dtype, else a numpy array."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(arr).to(device=template.device,
                                       dtype=template.dtype)
    return arr


def _key(i: int) -> str:
    return f"leaf_{i:05d}"


class CheckpointStore:
    def __init__(self, directory: str, host_id: int = 0):
        self.dir = directory
        self.host = host_id
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    # ---- write ---------------------------------------------------------

    def save(self, step: int, params: Any, opt_state: Any,
             extra: Optional[Dict[str, Any]] = None) -> str:
        self.wait()
        return self._write(step, params, opt_state, extra or {})

    def save_async(self, step: int, params: Any, opt_state: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot to host memory now; write to disk in the background."""
        self.wait()
        host_params = _host_tree(params)
        host_opt = _host_tree(opt_state)
        ex = dict(extra or {})

        def _bg():
            self._write(step, host_params, host_opt, ex, already_host=True)

        self._pending = threading.Thread(target=_bg, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, params, opt_state, extra,
               already_host: bool = False) -> str:
        tag = f"step_{step:09d}"
        tmp = os.path.join(self.dir, f".tmp_{tag}_{self.host}")
        final = os.path.join(self.dir, tag)
        os.makedirs(tmp, exist_ok=True)

        if not already_host:
            params = _host_tree(params)
            opt_state = _host_tree(opt_state)

        p_leaves, _ = _flatten(params)
        o_leaves, _ = _flatten(opt_state)
        np.savez(
            os.path.join(tmp, f"shard_h{self.host:03d}.npz"),
            **{f"p_{_key(i)}": np.asarray(x) for i, x in enumerate(p_leaves)},
            **{f"o_{_key(i)}": np.asarray(x) for i, x in enumerate(o_leaves)},
        )
        manifest = {
            "step": step,
            "time": time.time(),
            "n_param_leaves": len(p_leaves),
            "n_opt_leaves": len(o_leaves),
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)

        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                       # atomic publish of data
        ptr_tmp = os.path.join(self.dir, f".LATEST_{self.host}")
        with open(ptr_tmp, "w") as f:
            f.write(tag)
        os.replace(ptr_tmp, os.path.join(self.dir, "LATEST"))  # commit point
        return final

    # ---- read ----------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            tag = f.read().strip()
        path = os.path.join(self.dir, tag, "manifest.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(json.load(f)["step"])

    def restore(self, params_like: Any, opt_like: Any,
                step: Optional[int] = None) -> Tuple[Any, Any, int, Dict]:
        """Restore onto templates: each leaf on its template's device and
        in its dtype; a shape that differs from the template's raises."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        tag = f"step_{step:09d}"
        d = os.path.join(self.dir, tag)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, f"shard_h{self.host:03d}.npz")) as data:
            p_leaves, p_def = _flatten(params_like)
            o_leaves, o_def = _flatten(opt_like)
            new_p = [data[f"p_{_key(i)}"] for i in range(len(p_leaves))]
            new_o = [data[f"o_{_key(i)}"] for i in range(len(o_leaves))]
        for i, (old, new) in enumerate(zip(p_leaves + o_leaves,
                                           new_p + new_o)):
            if tuple(old.shape) != tuple(new.shape):
                raise ValueError(f"leaf {i}: checkpoint shape {new.shape} "
                                 f"!= template {tuple(old.shape)}")
        return (_unflatten(p_def, [_like(a, t) for a, t
                                   in zip(new_p, p_leaves)]),
                _unflatten(o_def, [_like(a, t) for a, t
                                   in zip(new_o, o_leaves)]),
                int(manifest["step"]), manifest.get("extra", {}))


# --------------------------------------------------------------------------
# chunk-granular checkpointing for streaming mega-sweeps
# --------------------------------------------------------------------------

class SweepCheckpoint:
    """Kill/resume store for a chunked (streaming) sweep.

    Layout::

        <dir>/manifest.json    # sweep fingerprint, grid meta, chunk bounds
        <dir>/chunk_00042.npz  # reduced results + meta of one finished chunk

    Same fault-tolerance discipline as :class:`CheckpointStore`: every file
    is written to a temp name in the same directory and published with
    ``os.replace``, so a SIGKILL mid-chunk leaves either the previous state
    or nothing — never a torn chunk. The *manifest* carries the caller's
    sweep fingerprint (a digest over the grid definition, lane configs,
    traces and chunking) and per-chunk digests; the streaming executor
    refuses to resume when the fingerprint of the on-disk manifest does not
    match the sweep being (re)launched, so a silently-edited grid can never
    splice stale chunks into fresh results.
    """

    MANIFEST = "manifest.json"

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    # ---- manifest ------------------------------------------------------

    def read_manifest(self) -> Optional[Dict]:
        path = os.path.join(self.dir, self.MANIFEST)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def write_manifest(self, manifest: Dict) -> None:
        path = os.path.join(self.dir, self.MANIFEST)
        fd, tmp = tempfile.mkstemp(dir=self.dir, prefix=".tmp_manifest_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, path)                    # atomic publish
        except BaseException:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise

    # ---- chunks --------------------------------------------------------

    def _chunk_path(self, idx: int) -> str:
        return os.path.join(self.dir, f"chunk_{idx:05d}.npz")

    def save_chunk(self, idx: int, arrays: Dict[str, np.ndarray],
                   meta: Dict) -> str:
        """Atomically publish one finished chunk: named arrays plus a JSON
        ``meta`` dict (stored as a zero-dim unicode array — no pickle)."""
        final = self._chunk_path(idx)
        fd, tmp = tempfile.mkstemp(dir=self.dir, prefix=".tmp_chunk_",
                                   suffix=".npz")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, __meta__=np.asarray(json.dumps(meta)),
                         **{k: np.asarray(v) for k, v in arrays.items()})
            os.replace(tmp, final)                   # atomic publish
        except BaseException:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise
        return final

    def load_chunk(self, idx: int) -> Optional[Tuple[Dict[str, np.ndarray],
                                                     Dict]]:
        """Load a finished chunk, or None if absent/unreadable (an
        unreadable chunk is dropped so the executor recomputes it)."""
        path = self._chunk_path(idx)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as data:
                meta = json.loads(str(data["__meta__"]))
                arrays = {k: data[k] for k in data.files if k != "__meta__"}
        except Exception:
            with contextlib.suppress(OSError):
                os.remove(path)
            return None
        return arrays, meta

    def done_chunks(self) -> List[int]:
        """Indices of chunks with a published blob (sorted)."""
        out = []
        for fn in os.listdir(self.dir):
            if fn.startswith("chunk_") and fn.endswith(".npz"):
                try:
                    out.append(int(fn[len("chunk_"):-len(".npz")]))
                except ValueError:
                    pass
        return sorted(out)

    def clear(self) -> None:
        """Drop the manifest and every chunk (fresh-start / refused
        resume with ``resume=False``)."""
        for fn in os.listdir(self.dir):
            if fn == self.MANIFEST or fn.startswith("chunk_") \
                    or fn.startswith(".tmp_"):
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(self.dir, fn))
