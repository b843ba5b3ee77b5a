"""Fault-tolerant checkpointing: atomic, async, device-agnostic — port of
``repro/checkpoint/ckpt.py``, in its on-disk format, so a checkpoint written
by either package loads into the other.

Layout (one directory per step):
    <dir>/step_000123/
        manifest.json          # leaf paths, shapes, numpy dtype names, extra
        arrays.msgpack.zst     # {path: raw bytes} (zstd-compressed msgpack;
                               # plain arrays.msgpack when zstandard is absent)
    <dir>/LATEST               # atomic pointer file

  * **atomic**   — written to step_xxx.tmp then os.rename'd, with the file
                   and directory fsyncs in the JAX package's order; LATEST
                   is written last through LATEST.tmp and os.replace, so a
                   killed writer never corrupts the restore point.
  * **async**    — ``CheckpointManager.save_async`` copies every leaf to
                   host memory before it returns (in stream order, so a
                   parameter the next step updates in place is saved with
                   its value at the call) and writes on a background thread.
  * **streamed** — the msgpack payload (``checkpoint/_msgpack.py``, no
                   ``msgpack`` package needed) goes to the file leaf by leaf
                   instead of being built in memory; the bytes are
                   ``msgpack.packb``'s.
  * **bounded**  — keep_last_k garbage collection.

Leaves are tensors (any device), numpy arrays or Python scalars, named by
``nn.module.flatten_with_paths``.  ``bfloat16`` leaves are raw bytes under
the dtype name ``"bfloat16"``, as the JAX manifest names them; a leaf's
dtype on load is the manifest's.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
import warnings
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

try:  # optional: fall back to uncompressed payloads when absent
    import zstandard
except ImportError:  # pragma: no cover - depends on environment
    zstandard = None

from repro_torch.checkpoint import _msgpack
from repro_torch.nn.module import flatten_with_paths, tree_unflatten

_warned_no_zstd = False

# torch dtype <-> the numpy dtype name the manifest carries
_DTYPE_NAMES = {torch.float64: "float64", torch.float32: "float32",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
                torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def _fsync_file(path: pathlib.Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: pathlib.Path) -> None:
    """Flush a directory's entry table: renames inside it are only durable
    once the directory itself is fsync'd (POSIX crash-consistency rule —
    rename-then-crash can otherwise resurrect the old entry)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _warn_no_zstd():
    global _warned_no_zstd
    if not _warned_no_zstd:
        warnings.warn("zstandard not installed; writing uncompressed "
                      "checkpoints (arrays.msgpack)", stacklevel=3)
        _warned_no_zstd = True


def _on_host(x, copy: bool) -> torch.Tensor:
    """``x`` as a CPU tensor; ``copy`` also copies a CPU tensor or array, so
    the caller may mutate the original afterwards."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype not in _DTYPE_NAMES:
            raise TypeError(f"checkpoint leaf dtype {x.dtype} has no numpy name")
        return x.to("cpu", copy=copy)
    return torch.from_numpy(np.array(x) if copy else np.asarray(x))


def _raw(t: torch.Tensor) -> memoryview:
    """The bytes of a CPU tensor in C order (numpy's ``tobytes``)."""
    flat = t.contiguous().reshape(-1)
    return memoryview(flat.view(torch.uint8).numpy())


def _write_payload(path: pathlib.Path, entries) -> None:
    with open(path, "wb") as f:
        if zstandard is not None:
            size = _msgpack.packed_size([(k, v.nbytes) for k, v in entries])
            cctx = zstandard.ZstdCompressor(level=3)
            # the frame carries its content size, which JAX's one-shot
            # ZstdDecompressor.decompress needs
            with cctx.stream_writer(f, size=size, closefd=False) as z:
                _msgpack.write_map(z, entries)
        else:
            _msgpack.write_map(f, entries)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(directory: Union[str, os.PathLike], step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None,
                    keep_last_k: int = 3) -> pathlib.Path:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    final = d / f"step_{step:08d}"
    tmp = d / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    arrays = {k: _on_host(v, copy=False) for k, v in flatten_with_paths(tree).items()}
    manifest = {
        "step": step,
        "time": time.time(),
        "extra": extra or {},
        "leaves": {k: {"shape": list(v.shape), "dtype": _DTYPE_NAMES[v.dtype]}
                   for k, v in arrays.items()},
    }
    entries = [(k, _raw(v)) for k, v in arrays.items()]
    if zstandard is not None:
        _write_payload(tmp / "arrays.msgpack.zst", entries)
    else:
        _warn_no_zstd()
        _write_payload(tmp / "arrays.msgpack", entries)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    _fsync_file(tmp / "manifest.json")
    _fsync_dir(tmp)

    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(d)          # the rename is durable before LATEST can name it
    # atomic LATEST pointer: contents fsync'd *before* the replace, parent
    # directory after — a crash anywhere in this window leaves either the
    # old pointer or the new one, never an empty/unsynced file
    ptr_tmp = d / "LATEST.tmp"
    with open(ptr_tmp, "w") as f:
        f.write(final.name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, d / "LATEST")
    _fsync_dir(d)
    _gc(d, keep_last_k)
    return final


def _gc(d: pathlib.Path, keep: int):
    steps = sorted(p for p in d.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and not p.name.endswith(".tmp"))
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: Union[str, os.PathLike]) -> Optional[int]:
    ptr = pathlib.Path(directory) / "LATEST"
    if not ptr.exists():
        return None
    return int(ptr.read_text().strip().split("_")[-1])


def _read_payload(src: pathlib.Path) -> Tuple[bytearray, Dict[str, memoryview]]:
    """-> (the one buffer, {path: slice of it}); writable, so tensors can
    view it without a copy."""
    zst, raw = src / "arrays.msgpack.zst", src / "arrays.msgpack"
    if zst.exists():
        if zstandard is None:
            raise ImportError(f"{zst} is zstd-compressed but the 'zstandard' "
                              "module is not installed")
        with open(zst, "rb") as f:
            buf = bytearray(zstandard.ZstdDecompressor().decompress(f.read()))
    else:
        with open(raw, "rb") as f:
            buf = bytearray(os.fstat(f.fileno()).st_size)
            view, got = memoryview(buf), 0
            while got < len(buf):
                n = f.readinto(view[got:])
                if not n:
                    raise ValueError(f"{raw}: file ended after {got} of "
                                     f"{len(buf)} bytes")
                got += n
    return buf, _msgpack.read_map(buf)


def _leaf_device(t, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if torch.is_tensor(t) and t.device.type != "meta":
        return t.device
    return torch.device("cpu")


def load_checkpoint(directory: Union[str, os.PathLike], template: Any,
                    step: Optional[int] = None,
                    device: Union[str, torch.device, None] = None
                    ) -> Tuple[Any, Dict[str, Any], int]:
    """Restore onto ``template``'s structure (leaves with ``shape``: tensors,
    on the ``meta`` device too, or arrays).  Each leaf lands on ``device``,
    or else on its template leaf's device (CPU for ``meta`` and arrays).
    Returns (tree of tensors, extra, step)."""
    d = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    src = d / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    _, payload = _read_payload(src)

    out = []
    for k, t in flatten_with_paths(template).items():
        meta = manifest["leaves"].get(k)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {k}")
        dtype = _TORCH_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise TypeError(f"{k}: checkpoint dtype {meta['dtype']!r} has no "
                            "torch counterpart")
        shape = tuple(meta["shape"])
        if shape != tuple(t.shape):
            raise ValueError(f"{k}: checkpoint {shape} vs model {tuple(t.shape)}")
        data = payload[k]
        arr = (torch.frombuffer(data, dtype=dtype) if data.nbytes
               else torch.empty(0, dtype=dtype)).reshape(shape)
        dev = _leaf_device(t, device)
        # a CPU leaf is copied out of the payload buffer, which is freed then
        out.append(arr.to(dev, copy=dev.type == "cpu"))
    return tree_unflatten(template, out), manifest.get("extra", {}), step


class CheckpointManager:
    """Async writer with SIGTERM-safe emergency saves and keep-last-k GC."""

    def __init__(self, directory: Union[str, os.PathLike], keep_last_k: int = 3,
                 save_every: int = 100):
        self.directory = directory
        self.keep_last_k = keep_last_k
        self.save_every = save_every
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None):
        """Snapshot to host memory now; write on a background thread."""
        self.wait()  # one writer at a time; also surfaces prior errors
        # copies, also of CPU tensors and arrays: the caller (an optimizer
        # updating in place) may change them after we return; a device
        # tensor's copy is taken in stream order, after its pending updates
        flat = flatten_with_paths(tree)
        host_tree = tree_unflatten(tree, [_on_host(v, copy=True)
                                          for v in flat.values()])

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra,
                                self.keep_last_k)
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def emergency_save(self, step: int, tree: Any,
                       extra: Optional[Dict[str, Any]] = None):
        """Synchronous save for SIGTERM / preemption handlers."""
        self.wait()
        save_checkpoint(self.directory, step, tree, extra, self.keep_last_k)
