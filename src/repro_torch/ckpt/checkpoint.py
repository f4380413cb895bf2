"""Async checkpointing — the MPI-storage-windows analogue.

Counterpart of ``repro/ckpt/checkpoint.py``. The paper maps windows to
storage and syncs them after each Map task; the transfer overlaps
compute, so the observed overhead is small (~4.8 %, paper Fig 5).

A snapshot is ``step-N/arrays.npz`` plus ``manifest.json``, committed by
an atomic rename, with the reference's leaf keys (an ``EngineCarry``
leaf is ``.table``, ``.pending_k``, ...): a snapshot either package
writes restores into the other; a bf16 leaf is stored as the
reference's npz stores one, as raw 2-byte void (``V2``). A training
state goes through ``train.train_step.state_tree``. ``keep`` bounds the
snapshots on disk.

The reference can hand its immutable arrays to the worker thread. The
port's carry is written in place (the window's scatter, the fused
step's CUDA graphs), so :meth:`CheckpointManager.save_async` copies it
before it returns: leaves on a CUDA device into pinned host buffers on
the current stream, with an event the worker waits on, leaves on the
CPU by a clone. A later segment then cannot tear the snapshot, and the
device-to-host transfer and the write still overlap it.

A fleet snapshot (:class:`FleetCheckpoint`) is one such manager a job
plus the scheduler's queue state in ``fleet.json``, in the reference's
layout, so fleet snapshots too cross between the packages both ways.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import threading
import time
import zipfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch


def _flatten(tree, path=()):
    """``[(path, leaf)]`` in the reference's order: a NamedTuple's
    fields (key ``.name``), a dict's sorted keys, a sequence's indices;
    ``None`` holds no leaf, as in a JAX pytree."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), path + (f".{f}",))]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, path + (str(i),))]
    return [(path, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _leaf_key(path) -> str:
    return "/".join(path)


def _stage(tree) -> tuple[dict, list]:
    """Copy every leaf now: ``({key: host copy}, [events])``. A CUDA
    leaf goes into a pinned host buffer by a copy on its device's
    current stream, which an event marks; the host buffer holds the
    values only once that event has completed."""
    staged, events = {}, {}
    for path, leaf in _flatten(tree):
        key = _leaf_key(path)
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.is_cuda:
                host = torch.empty(leaf.shape, dtype=leaf.dtype,
                                   pin_memory=True)
                host.copy_(leaf, non_blocking=True)
                if leaf.device not in events:
                    events[leaf.device] = torch.cuda.Event()
                staged[key] = host
            else:
                staged[key] = leaf.clone()
        else:
            staged[key] = np.array(leaf)
    for device, event in events.items():
        event.record(torch.cuda.current_stream(device))
    return staged, list(events.values())


def _host_array(v) -> np.ndarray:
    """What npz stores for a staged leaf. numpy has no bf16: a bf16
    tensor is written as the reference's npz holds ml_dtypes' bf16, its
    16-bit patterns as a 2-byte void (``V2``) array."""
    if not isinstance(v, torch.Tensor):
        return v
    if v.dtype == torch.bfloat16:
        return v.view(torch.int16).numpy().view(np.dtype("V2"))
    return v.numpy()


def _tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype and device. Raw
    void bytes (a bf16 leaf of either package) are reinterpreted when
    their width is the dtype's, as the reference's ``restore`` does;
    anything else is cast. A 0-d array stays 0-d."""
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == like.element_size():
        t = torch.from_numpy(arr.view(f"i{arr.dtype.itemsize}")) \
            .view(like.dtype)
    else:
        t = torch.from_numpy(arr).to(like.dtype)
    return t.to(like.device)


def _numpy_dtype(dtype: torch.dtype):
    return (None if dtype == torch.bfloat16
            else torch.empty(0, dtype=dtype).numpy().dtype)


def _read_stored(f, info, like: torch.Tensor) -> torch.Tensor | None:
    """An npz member read by one ``readinto`` straight into a new host
    tensor of ``like``'s dtype (pinned when it goes on to a card), then
    moved to ``like``'s device: ``np.load`` copies a member in small
    chunks and checks its CRC, a few times slower for the gigabytes of a
    training state. None for a member this cannot read as raw bytes
    (compressed, Fortran order, another dtype): ``_tensor`` decodes
    those."""
    if info is None or info.compress_type != zipfile.ZIP_STORED:
        return None
    f.seek(info.header_offset)
    name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
    f.seek(info.header_offset + 30 + name_len + extra_len)
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        return None
    raw = (dtype.kind == "V" and dtype.itemsize == like.element_size()) \
        or dtype == _numpy_dtype(like.dtype)
    if fortran or not raw:
        return None
    host = torch.empty(shape, dtype=like.dtype, pin_memory=like.is_cuda)
    view = memoryview(host.reshape(-1).view(torch.uint8).numpy())
    done = 0
    while done < len(view):
        n = f.readinto(view[done:])
        if not n:
            raise EOFError(f"{info.filename}: the archive ends early")
        done += n
    return host.to(like.device, non_blocking=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 2):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="checkpoint")
        self._lock = threading.Lock()
        self._futures: list[Future] = []
        self._texts: dict[tuple, str] = {}     # array digest -> JSON

    # -- save ---------------------------------------------------------------

    def save_async(self, step: int, tree: Any,
                   extra: dict | None = None) -> Future:
        """Copy ``tree`` (see the module's docstring), then write it in
        the worker thread: the transfer and the write overlap whatever
        the caller enqueues next."""
        fut = self._pool.submit(self._save, step, _stage(tree), extra or {})
        self._futures.append(fut)
        return fut

    def save(self, step: int, tree: Any, extra: dict | None = None):
        return self._save(step, _stage(tree), extra or {})

    def _save(self, step: int, staged: tuple[dict, list], extra: dict):
        t0 = time.perf_counter()
        leaves, events = staged
        for event in events:
            event.synchronize()
        arrays = {k: _host_array(v) for k, v in leaves.items()}
        tmp = os.path.join(self.dir, f".tmp-{step}")
        final = os.path.join(self.dir, f"step-{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        text = self._manifest(step, len(arrays), extra,
                              time.perf_counter() - t0)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            f.write(text)
        with self._lock:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)           # atomic commit
            self._gc()
        return final

    def _manifest(self, step, n_leaves: int, extra: dict, wall: float):
        """The manifest's JSON text, a numpy array in ``extra`` written as
        the nested list it holds."""
        items = ", ".join(f"{json.dumps(str(k))}: {self._json(v)}"
                          for k, v in extra.items())
        return (f'{{"step": {json.dumps(step)}, "n_leaves": {n_leaves}, '
                f'"extra": {{{items}}}, "wall": {json.dumps(wall)}}}')

    def _json(self, value) -> str:
        """JSON text of one value. An array's is kept by a digest of its
        bytes: a job's assignment grids (2**20 ints at the smoke's width)
        change only on a re-plan or a seek, and encoding them holds the
        interpreter lock for ~0.1 s, which the segments' launches need."""
        if not isinstance(value, np.ndarray):
            return json.dumps(value)
        key = (hashlib.sha1(value.tobytes()).digest(), value.shape,
               value.dtype.str)
        if key not in self._texts:
            kept = list(self._texts.items())[-3:]
            self._texts = dict(kept + [(key, json.dumps(value.tolist()))])
        return self._texts[key]

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def peek(self, step: int | None = None) -> tuple[int, dict]:
        """A snapshot's manifest ``extra``, without reading its arrays:
        compatibility checks and the feed's seek cost no array I/O."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with open(os.path.join(self.dir, f"step-{step}",
                               "manifest.json")) as f:
            return step, json.load(f).get("extra", {})

    def restore(self, tree_like: Any,
                step: int | None = None) -> tuple[int, Any, dict]:
        """``(step, tree, extra)``: ``tree_like`` gives the structure, and
        each of its leaves the dtype and device of the restored leaf (a
        numpy leaf comes back as numpy)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step-{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = []
        npz = os.path.join(d, "arrays.npz")
        with np.load(npz) as data, zipfile.ZipFile(npz) as zf, \
                open(npz, "rb", buffering=0) as raw:
            members = {i.filename: i for i in zf.infolist()}
            for path, like in _flatten(tree_like):
                key = _leaf_key(path)
                if isinstance(like, torch.Tensor):
                    t = _read_stored(raw, members.get(key + ".npy"), like)
                    leaves.append(_tensor(data[key], like) if t is None
                                  else t)
                else:
                    leaves.append(data[key].astype(np.asarray(like).dtype))
        tree = _unflatten(tree_like, iter(leaves))
        return step, tree, manifest.get("extra", {})

    def wait(self):
        """Block until every async save has committed; raises the first
        save's error, if one failed."""
        self._pool.shutdown(wait=True)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="checkpoint")
        futures, self._futures = self._futures, []
        for fut in futures:
            fut.result()


class FleetStateError(RuntimeError):
    """The fleet manifest (``fleet.json``) is missing or unreadable.

    Raised by :meth:`FleetCheckpoint.load_state` with the directory and
    the surviving per-job snapshot names in the message: after a crash
    the per-job snapshots usually survive even when the queue-state
    commit did not, and each job can still be resumed on its own through
    ``FleetCheckpoint.manager(name)``."""


class FleetCheckpoint:
    """Scheduler-level checkpoint root: one :class:`CheckpointManager` a
    job (``<dir>/job-<name>/``) plus a queue-state manifest
    (``fleet.json``, committed by an atomic rename).

    A fleet snapshot is the set of per-job snapshots plus the
    scheduler's queue state (admission order, tenants, priorities,
    accounting); ``repro_torch.core.scheduler.JobScheduler.checkpoint``
    and ``restore`` are the front door. Finished jobs' results are not
    persisted: on restore they resume from their latest per-job snapshot
    (or from scratch if none was taken), which re-runs only the work
    after that snapshot.
    """

    STATE = "fleet.json"

    def __init__(self, directory: str, keep: int = 2):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._managers: dict[str, CheckpointManager] = {}

    @staticmethod
    def _safe(name: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in name)
        if safe == name:
            return safe
        # the sanitizing is lossy ("job/1" and "job_1" both give "job_1"):
        # a digest of the raw name keeps two jobs from sharing a snapshot
        # directory, and restore, which derives the path from the same
        # name, still finds it
        digest = hashlib.sha1(name.encode()).hexdigest()[:8]
        return f"{safe}-{digest}"

    def _job_dir(self, name: str) -> str:
        return os.path.join(self.dir, f"job-{self._safe(name)}")

    def manager(self, name: str) -> CheckpointManager:
        """The job's CheckpointManager (made at first use)."""
        if name not in self._managers:
            self._managers[name] = CheckpointManager(self._job_dir(name),
                                                     keep=self.keep)
        return self._managers[name]

    def has_snapshot(self, name: str) -> bool:
        return (os.path.isdir(self._job_dir(name))
                and self.manager(name).latest_step() is not None)

    def save_state(self, state: dict) -> str:
        tmp = os.path.join(self.dir, ".fleet.tmp")
        final = os.path.join(self.dir, self.STATE)
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
            # the rename is atomic only for bytes that reached the disk:
            # without the fsync a crash can commit a truncated manifest
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)               # atomic commit
        return final

    def has_state(self) -> bool:
        """True when a committed fleet manifest exists (it may still be
        unreadable: ``load_state`` then raises :class:`FleetStateError`)."""
        return os.path.isfile(os.path.join(self.dir, self.STATE))

    def _snapshot_names(self) -> list[str]:
        try:
            return sorted(n for n in os.listdir(self.dir)
                          if n.startswith("job-")
                          and os.path.isdir(os.path.join(self.dir, n)))
        except OSError:
            return []

    def load_state(self) -> dict:
        path = os.path.join(self.dir, self.STATE)
        snaps = self._snapshot_names()
        surviving = (", ".join(snaps) if snaps
                     else "none — nothing was ever checkpointed here")
        if not os.path.isfile(path):
            raise FleetStateError(
                f"no fleet manifest ({self.STATE}) in {self.dir!r}; "
                f"surviving per-job snapshot dirs: {surviving}. Jobs can "
                "still be resumed one at a time via "
                "FleetCheckpoint.manager(<name>), but queue state "
                "(policy, tenants, accounting) is gone")
        try:
            with open(path) as f:
                return json.load(f)
        except ValueError as e:
            raise FleetStateError(
                f"fleet manifest {path!r} is unreadable ({e}); surviving "
                f"per-job snapshot dirs: {surviving}. The manifest commit "
                "is fsync+rename-atomic, so this file was likely "
                "corrupted after the fact") from e

    def wait(self):
        """Flush every job's async save: call before committing the fleet
        manifest, so that it never names a torn snapshot."""
        for m in self._managers.values():
            m.wait()
