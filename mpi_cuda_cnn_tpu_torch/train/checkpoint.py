"""Checkpoint and resume (counterpart of the reference's
`train/checkpoint.py`), in the same files, so that each package restores
the other's.

The C reference has no serialization: weights live and die in process
memory. A checkpoint here is `ckpt_{step}.npz`, one array per leaf of
the state, named by its path ("params/0/w", "opt_state/0/.mu/head",
"step"), beside a `manifest.json` holding `latest_step`, the array
`keys`, a crc32 per array of every live checkpoint (`checksums`) and a
`meta` entry per file (the topology it was written under). The trainers
name their state as the JAX package names its optax state
(`convert.checkpoint_arrays`); this module flattens any tree of dicts
and lists whose leaves are tensors or arrays.

bfloat16 leaves are written as the JAX package writes them: numpy has no
bfloat16, so `np.savez` stores the 2-byte values as void (`|V2`), and
the manifest's checksum names them "bfloat16" (`_checksum`), as the
JAX package's checksum of the live array does. A restore reads a `|V2`
array whose template leaf is bfloat16 as those bits (`to_tensor`), so
the port resumes its own bf16 files and the JAX package's bit for bit.

Crash safety: the npz and the manifest each land by a tmp write and an
atomic rename, pruning runs only after the new file's rename (and never
deletes the `protect`ed file a run resumed from), `restore_checkpoint`
verifies the checksums, and `restore_latest` walks newest first past
corrupt or torn files. A missing or unparsable manifest falls back to
the `ckpt_*.npz` glob without verification.
"""

from __future__ import annotations

import json
import re
import time
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch

from ..parallel.mesh import describe_mesh

_STEP_RE = re.compile(r"ckpt_(\d+)\.npz$")

MANIFEST = "manifest.json"

# Per process: the checkpoint files this process wrote (a non-writing
# rank writes none), as `dp.collectives` counts collectives.
counts: dict[str, int] = {"written": 0}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint's bytes do not match its manifest checksums."""


def named_leaves(tree, prefix: str = ""):
    """(name, leaf) of a tree of dicts and lists: the reference's key-path
    names ("/"-joined dict keys and list indices, after `prefix`, which
    ends in "/" when given), dict keys in sorted order as `jax.tree_util`
    walks them (the order of `models.layers.tree_leaves`)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


# How numpy (and so np.savez) holds a bfloat16 array: its 2-byte values
# as void.
_BF16_NP = np.dtype("V2")


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf that later in-place updates cannot reach (a
    bfloat16 tensor's bits as `|V2`)."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(_BF16_NP)
        return host.numpy()
    return np.array(leaf, copy=True)


def to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A restored array as a CPU tensor (`|V2` bits as bfloat16)."""
    arr = np.asarray(arr)
    if arr.dtype == _BF16_NP:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(state) -> dict[str, np.ndarray]:
    return {name: _host(leaf) for name, leaf in named_leaves(state)}


def _np_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _BF16_NP
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _checksum(arr: np.ndarray) -> str:
    """crc32 over the array's bytes, then its dtype and shape (so that a
    reinterpretation cannot collide): integrity, not cryptography. A
    `|V2` array is bfloat16 and named so, as the JAX package names its
    live bfloat16 array."""
    crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
    name = "bfloat16" if arr.dtype == _BF16_NP else arr.dtype
    crc = zlib.crc32(f"{name}:{arr.shape}".encode(), crc)
    return f"{crc:08x}"


def _load_manifest(ckpt_dir: Path) -> dict | None:
    """The directory's manifest, or None when missing or unparsable."""
    try:
        mf = json.loads((ckpt_dir / MANIFEST).read_text())
    except (OSError, json.JSONDecodeError):
        return None
    return mf if isinstance(mf, dict) else None


def _atomic_write_text(path: Path, text: str) -> None:
    tmp = path.parent / f".{path.name}.tmp"
    tmp.write_text(text)
    tmp.rename(path)


def save_checkpoint(ckpt_dir: str | Path, state, step: int, *, keep: int = 3,
                    faults=None, meta: dict | None = None,
                    protect: str | None = None, process=None,
                    barrier=None) -> Path:
    """Write `state` as ckpt_{step}.npz and update the manifest; prune to
    the newest `keep` files (never `protect`).

    Both files are tmp-written then renamed, so a crash at any point
    leaves the previous consistent pair or the new one. `faults` (a
    `faults.FaultInjector`) fires "ckpt.pre_rename" between the npz's
    tmp write and its rename and "ckpt.manifest" before the manifest
    update. `meta` is recorded for this file in the manifest. With
    `process` (`parallel.distributed.ProcessInfo`) and `barrier`, only
    process 0 touches the filesystem, and every process then meets at
    the barrier (named by the step), so none reads before the writer
    is done."""
    ckpt_dir = Path(ckpt_dir)
    path = ckpt_dir / f"ckpt_{step}.npz"
    fence = f"ckpt_save_{step}"
    if process is not None and process.process_index != 0:
        if barrier is not None:
            barrier(fence)
        return path
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = {name: np.asarray(leaf) if isinstance(leaf, np.ndarray)
            else _host(leaf) for name, leaf in named_leaves(state)}
    # A dotfile (invisible to the ckpt_*.npz glob) that still ends in
    # .npz, or np.savez appends the suffix itself.
    tmp = ckpt_dir / f".ckpt_{step}.tmp.npz"
    np.savez(tmp, **flat)
    if faults is not None:
        faults.fire("ckpt.pre_rename", step)
    tmp.rename(path)
    counts["written"] += 1
    if faults is not None:
        faults.fire("ckpt.manifest", step)
    mf = _load_manifest(ckpt_dir) or {}
    checksums = mf.get("checksums")
    if not isinstance(checksums, dict):
        checksums = {}
    checksums[path.name] = {k: _checksum(v) for k, v in flat.items()}
    metas = mf.get("meta")
    if not isinstance(metas, dict):
        metas = {}
    if meta is not None:
        metas[path.name] = meta
    live = _list_checkpoints(ckpt_dir)
    drop = [p for p in live[:-keep] if p.name != protect]
    for p in drop:
        p.unlink()
        checksums.pop(p.name, None)
    kept = {p.name for p in live if p not in drop}
    _atomic_write_text(ckpt_dir / MANIFEST, json.dumps({
        "latest_step": step,
        "keys": sorted(flat),
        "checksums": {n: c for n, c in sorted(checksums.items())
                      if n in kept},
        "meta": {n: m for n, m in sorted(metas.items()) if n in kept},
    }, indent=2))
    if barrier is not None:
        barrier(fence)
    return path


def checkpoint_meta(ckpt_dir: str | Path, name: str) -> dict | None:
    """The manifest's meta entry of checkpoint `name` (mesh, elastic
    width, process count), or None without one."""
    mf = _load_manifest(Path(ckpt_dir))
    if mf is None:
        return None
    metas = mf.get("meta")
    entry = metas.get(name) if isinstance(metas, dict) else None
    return entry if isinstance(entry, dict) else None


def validate_resume_meta(ckpt_path, *, mesh, elastic_width: int, metrics,
                         logger) -> None:
    """Hold a restored checkpoint's recorded topology to the live one. A
    changed mesh is logged (a ``fault`` record, kind
    "topology_change"): full-array checkpoints restore on any mesh. A
    changed elastic width raises ValueError: the bitwise contract of the
    width-invariant reduction would break mid-run. A checkpoint without
    meta passes."""
    meta = checkpoint_meta(Path(ckpt_path).parent, Path(ckpt_path).name)
    if meta is None:
        return
    saved_w = meta.get("elastic_width")
    if saved_w is not None and int(saved_w) != int(elastic_width):
        raise ValueError(
            f"checkpoint {Path(ckpt_path).name} was written with "
            f"--elastic-width {saved_w}, this run uses {elastic_width}: "
            "the canonical reduction tree would change mid-run — "
            "resume with the original width"
        )
    saved_mesh = meta.get("mesh") or {}
    live = describe_mesh(mesh)
    if saved_mesh and saved_mesh != live:
        metrics.log("fault", kind="topology_change", saved=saved_mesh,
                    live=live)
        logger.info(
            "topology changed across resume: checkpoint written under "
            "%s, resuming under %s (full-array checkpoints restore on any "
            "mesh)", saved_mesh, live,
        )


class AsyncCheckpointer:
    """Checkpoint writes overlapped with the next training steps.

    save() copies the state to the host before it returns (the next
    step updates the tensors in place) and hands the arrays to ONE
    background worker, which writes, renames and prunes. At most one
    write is in flight: a second save() first waits for the previous
    one. A failed write re-raises at the next save() or wait().
    async_=False, and worlds of several processes (whose barrier is a
    collective that must stay ordered with the steps' collectives on
    the main thread), save synchronously.
    """

    def __init__(self, ckpt_dir: str | Path, *, keep: int = 3,
                 async_: bool = True, faults=None, meta: dict | None = None,
                 process=None, barrier=None):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self.faults = faults
        self.meta = meta
        # The checkpoint this run resumed from: pruning never deletes it.
        self.protect: str | None = None
        self.process = process
        self.barrier = barrier
        # The step of the latest save issued (a preemption drain on the
        # same boundary does not write it twice).
        self.last_step: int | None = None
        # Seconds of the latest save() call (the host copy, and the
        # write itself when synchronous) and of the latest write.
        self.save_s = 0.0
        self.write_s = 0.0
        self._executor = None
        self._pending = None
        if async_:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt")

    def _kwargs(self, barrier=None) -> dict:
        return dict(keep=self.keep, faults=self.faults, meta=self.meta,
                    protect=self.protect, process=self.process,
                    barrier=barrier)

    def _write(self, host, step: int, barrier=None) -> Path:
        t0 = time.perf_counter()
        path = save_checkpoint(self.ckpt_dir, host, step,
                               **self._kwargs(barrier))
        self.write_s = time.perf_counter() - t0
        return path

    def save(self, state, step: int) -> None:
        """Copy `state` to the host and schedule its write."""
        t0 = time.perf_counter()
        self.last_step = step
        if self._executor is None or (
                self.process is not None and self.process.process_count > 1):
            self._write(state, step, barrier=self.barrier)
        else:
            self.wait()  # drain (and re-raise from) the write in flight
            host = _flatten(state)
            # barrier=None: the worker thread makes no collective.
            self._pending = self._executor.submit(self._write, host, step)
        self.save_s = time.perf_counter() - t0

    def wait(self) -> None:
        """Block until the write in flight (if any) lands; re-raise its
        error."""
        if self._pending is not None:
            fut, self._pending = self._pending, None
            fut.result()

    def close(self) -> None:
        """Drain and release the worker. Later saves are synchronous."""
        self.wait()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def __enter__(self) -> AsyncCheckpointer:
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            if self._pending is not None:
                def _log_failure(fut):
                    err = fut.exception()
                    if err is not None:
                        import logging

                        logging.getLogger("mpi_cuda_cnn_tpu_torch").error(
                            "async checkpoint write failed (object "
                            "dropped before wait/close): %r", err)

                self._pending.add_done_callback(_log_failure)
            if self._executor is not None:
                self._executor.shutdown(wait=False)
        except Exception:
            pass  # interpreter teardown: never raise from __del__


def _list_checkpoints(ckpt_dir: Path) -> list[Path]:
    found = [(int(m.group(1)), p) for p in ckpt_dir.glob("ckpt_*.npz")
             if (m := _STEP_RE.search(p.name))]
    return [p for _, p in sorted(found)]


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None
    ckpts = _list_checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def _rebuild(tree, arrays: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, arrays, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, arrays, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return arrays[prefix[:-1]]


def restore_checkpoint(path: str | Path, state_template, *,
                       verify: bool = True):
    """The checkpoint at `path` in the structure of `state_template` (a
    tree as saved; only its names and dtypes are read), numpy leaves.
    Missing or extra keys raise ValueError: a resume must be exact. With
    `verify`, each array is held to the manifest's crc32 when the
    manifest records this file (CheckpointCorruptError on a mismatch;
    an unreadable archive raises it too)."""
    path = Path(path)
    try:
        archive = np.load(path)
    except ValueError as e:
        # np.load reports unrecognized bytes as ValueError ("pickled
        # data"); plain ValueError stays for structure mismatches.
        raise CheckpointCorruptError(
            f"{path.name}: unreadable archive: {e}") from e
    with archive:
        named = dict(named_leaves(state_template))
        if set(archive.files) != set(named):
            missing = set(named) - set(archive.files)
            extra = set(archive.files) - set(named)
            raise ValueError(f"checkpoint mismatch: missing={missing} "
                             f"extra={extra}")
        sums = None
        if verify:
            mf = _load_manifest(path.parent)
            if mf is not None:
                entry = mf.get("checksums", {})
                sums = (entry.get(path.name) if isinstance(entry, dict)
                        else None)
        arrays = {}
        for key, leaf in named.items():
            arr = archive[key]
            if sums is not None and key in sums \
                    and _checksum(arr) != sums[key]:
                raise CheckpointCorruptError(
                    f"{path.name}: array {key!r} fails its manifest "
                    "checksum — the file is corrupt")
            arrays[key] = np.asarray(arr, dtype=_np_dtype(leaf))
    return _rebuild(state_template, arrays)


def restore_latest(ckpt_dir: str | Path, state_template, *, logger=None,
                   metrics=None):
    """The newest checkpoint that verifies, falling back past corrupt or
    torn files. Returns (state, path), or (None, None) when none
    restores. Structure mismatches (ValueError) propagate; corruption
    logs a warning and a ``fault`` record (kind "ckpt_fallback") and
    moves on to the previous file."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None, None
    for path in reversed(_list_checkpoints(ckpt_dir)):
        try:
            return restore_checkpoint(path, state_template), path
        except (CheckpointCorruptError, zipfile.BadZipFile, OSError,
                EOFError, KeyError) as e:
            if logger is not None:
                logger.warning(
                    "checkpoint %s is corrupt (%s: %s); falling back to "
                    "the previous one", path.name, type(e).__name__, e)
            if metrics is not None:
                metrics.log("fault", kind="ckpt_fallback", path=path.name,
                            error=f"{type(e).__name__}: {e}")
    return None, None
