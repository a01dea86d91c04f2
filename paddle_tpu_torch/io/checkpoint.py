"""Checkpoint/resume: async, verified, managed step checkpoints (the
port's counterpart of ``paddle_tpu/io/checkpoint.py``).

The lifecycle is the JAX package's, name for name:

- **async save** — ``save(step, tree, async_=True)`` snapshots the tree
  to host buffers (the caller stalls only for the device→host copy),
  then a background writer thread commits it through the atomic commit
  and the ``RetryPolicy``; a second async save barriers on the first
  (≤ 2 snapshots alive), and ``wait_until_finished``/``flush`` are the
  explicit barriers (fit exit / SIGTERM emergency flush).
- **integrity manifests** — every committed step gets an atomically
  renamed ``manifest-<step>.json`` sidecar with per-leaf blake2b
  digests plus a small JSON ``state`` blob (RNG key, DataLoader cursor,
  metric state — the exact-resume bundle). ``latest_step`` only
  surfaces manifested steps, so a kill between the data commit and the
  manifest write costs exactly that step, never corruption.
- **verified restore** — ``restore`` recomputes digests; a mismatch
  raises :class:`CheckpointCorrupt` (explicit step) or quarantines the
  step and falls back to the newest step that verifies (auto), dumping
  a flight record with the digest diff.
- **GC** — keep-last-N operates on VERIFIED manifests and never deletes
  the newest verified step; debris (data dirs without a manifest, from
  kills mid-commit) is swept at open and before re-saving a step.

Format. The JAX package commits its data through orbax; the port writes
its own step directory: each leaf one ``.npy`` file (bf16 stored as its
raw 2-byte payload, so it stays exact without ml_dtypes) and
``tree.json`` for the structure, written under a temporary name and
renamed to ``<dir>/<step>`` once every file is fsynced. The directory
layout (``<step>/``, ``manifest-<step>.json``, ``.manifest-era``,
``.corrupt`` quarantine) and the manifest JSON (``format``, ``step``,
``ts``, ``digests``, ``state``) are the JAX package's: for the same tree
both packages write the same digest map — keys are
``jax.tree_util.keystr`` paths (``['opt']['m']['fc.weight']``), a digest
hashes the numpy dtype name, the shape as a tuple of ints and the raw
bytes, and a host ``int`` hashes as the 0-d int32 the JAX optimizer
keeps — and each package's :func:`latest_manifest_step` reads the
other's directory. Restoring a step that the JAX package wrote (an orbax
data directory) is not supported and raises ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.monitor import stat_add
from ..observability import goodput as _goodput
from ..observability import memory as _memobs
from ..observability import metrics as _obs
from ..reliability import faults as _faults
from ..reliability.faults import FaultInjected
from ..reliability.retry import RetryPolicy, as_deadline

# shared save-dispatch retry: a transient filesystem error — or an
# injected ckpt.write fault — re-dispatches the save; the atomic commit
# makes a retried save safe (a failed attempt leaves only an uncommitted
# tmp dir, removed by the attempt or swept at the next open)
_SAVE_RETRY = RetryPolicy(max_attempts=3, base_delay=0.05,
                          max_delay=1.0, jitter=0.5,
                          retry_on=(OSError, FaultInjected),
                          scope="checkpoint")

# the tmp-dir tag of an uncommitted step directory: the JAX package's
# (orbax's) tag, so that either package's open-time sweep reclaims the
# other's debris
_TMP_TAG = "orbax-checkpoint-tmp"
_TREE_FILE = "tree.json"
_TREE_FORMAT = "paddle_tpu_torch.checkpoint/1"
# files orbax writes into a committed step: a JAX-package step directory
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA")
_HASH_THREADS = min(8, os.cpu_count() or 1)
# the longest a barrier waits on the writer thread (a commit of a
# multi-GB state takes seconds): past it the wait raises TimeoutError
# naming the barrier instead of hanging
_BARRIER_TIMEOUT_S = 600.0


def _ckpt_metrics():
    reg = _obs.default_registry()
    return {
        "save": reg.histogram(
            "checkpoint_save_seconds",
            "checkpoint commit wall time (write + atomic rename)"),
        "restore": reg.histogram(
            "checkpoint_restore_seconds", "checkpoint restore wall time"),
        "bytes": reg.counter(
            "checkpoint_bytes_written",
            "array bytes handed to checkpoint saves"),
        "snapshot": reg.histogram(
            "ckpt_snapshot_seconds",
            "device→host snapshot wall time — the ONLY part of an "
            "async save the train loop stalls on"),
        "queue": reg.gauge(
            "ckpt_commit_queue_depth",
            "async checkpoint snapshots enqueued or committing"),
        "verify_fail": reg.counter(
            "ckpt_verify_failures_total",
            "restores whose recomputed digests mismatched the manifest"),
        "flush": reg.counter(
            "ckpt_emergency_flush_total",
            "emergency (deadline-budgeted) checkpoint flushes",
            label_names=("outcome",)),
    }


# -- trees -------------------------------------------------------------------
#
# A tree is nested dicts, lists and tuples (None is an empty subtree, as
# in jax.tree_util) over leaves: torch tensors, numpy arrays and host
# Python scalars.

def _sorted_keys(d: dict) -> list:
    try:
        return sorted(d)
    except TypeError:
        return sorted(d, key=repr)


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in jax.tree_util's order: dict keys
    sorted, sequences by index."""
    if isinstance(tree, dict):
        out = []
        for k in _sorted_keys(tree):
            out += _flatten(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{path}[{i}]")
        return out
    if tree is None:
        return []
    return [(path, tree)]


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``bfloat16`` for bf16, which
    numpy lacks and ml_dtypes names so)."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _kind(leaf: Any) -> str:
    if isinstance(leaf, _HostLeaf):
        return leaf.kind
    if isinstance(leaf, torch.Tensor):
        return "tensor"
    if isinstance(leaf, (bool, np.bool_)):
        return "bool"
    if isinstance(leaf, int):
        return "int"
    if isinstance(leaf, float):
        return "float"
    return "ndarray"


def _host_array(leaf: Any) -> Tuple[str, np.ndarray]:
    """(dtype name, C-contiguous host array of the leaf's raw bytes): a
    bf16 tensor comes back as its int16 bit pattern; a host ``int`` is
    the 0-d int32 the JAX package's optimizer keeps its counter in. CPU
    tensors are viewed, not copied; CUDA tensors are copied to the
    host."""
    if isinstance(leaf, _HostLeaf):
        return leaf.name, leaf.array
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        name = _dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, t.numpy()
    if isinstance(leaf, (bool, np.bool_)):
        a = np.asarray(leaf, np.bool_)
    elif isinstance(leaf, int):
        a = np.asarray(leaf, np.int32)
    else:
        a = np.asarray(leaf, order="C")   # keeps a 0-d leaf 0-d
    return str(a.dtype), a


class _HostLeaf:
    """A leaf converted to host bytes once, for the commit's write and
    its digests: ``_host_array`` and ``_kind`` read the cached values."""

    __slots__ = ("kind", "name", "array")

    def __init__(self, leaf: Any):
        self.kind = _kind(leaf)
        self.name, self.array = _host_array(leaf)


def _tree_bytes(tree: Any) -> int:
    total = 0
    for _path, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += int(leaf.nbytes)
    return total


def _record_save(dt: float, tree: Any) -> None:
    m = _ckpt_metrics()
    nbytes = _tree_bytes(tree)
    m["save"].observe(dt)
    m["bytes"].inc(nbytes)
    # STAT_ADD wiring (monitor.h idiom). Names must not sanitize to the
    # same Prometheus name as the histograms above
    stat_add("checkpoint.saves", 1)
    stat_add("checkpoint.save_wall_seconds", dt)
    stat_add("checkpoint.saved_bytes", nbytes)


def _record_restore(dt: float) -> None:
    _ckpt_metrics()["restore"].observe(dt)
    stat_add("checkpoint.restores", 1)
    stat_add("checkpoint.restore_wall_seconds", dt)


class CheckpointCorrupt(RuntimeError):
    """A restored checkpoint's bytes do not match the digests recorded
    in its manifest at save time. ``step`` names the bad step; ``diff``
    maps leaf paths to {expected, actual} digest pairs (``actual`` is
    None for leaves missing from the restored tree)."""

    def __init__(self, step: int, diff: Dict[str, Dict[str, Any]]):
        bad = ", ".join(sorted(diff)[:4])
        more = f" (+{len(diff) - 4} more)" if len(diff) > 4 else ""
        super().__init__(
            f"checkpoint step {step} failed integrity verification: "
            f"digest mismatch at {bad}{more}")
        self.step = step
        self.diff = diff


# -- manifest sidecars -------------------------------------------------------
#
# manifest-<step>.json is written (atomic tmp+rename) AFTER the data
# commit, so its presence certifies a complete checkpoint; a quarantined
# (corrupt) step keeps its data dir for forensics under
# manifest-<step>.json.corrupt and stops being surfaced by latest_step.

_MANIFEST_FMT = "manifest-{step}.json"
# Touched before the FIRST data commit (and at open of any directory
# that already holds manifests): marks the directory as manifest-era,
# so a kill between the first-ever commit and its manifest write leaves
# debris, never a resurrected unverified "legacy" step.
_ERA_MARKER = ".manifest-era"
_CORRUPT_SUFFIX = ".corrupt"


def _manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, _MANIFEST_FMT.format(step=int(step)))


def _scan_manifest_steps(directory: str) -> List[int]:
    """Sorted steps with a committed (non-quarantined) manifest.
    Stdlib-only — the elastic launcher calls this."""
    steps = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        if name.startswith("manifest-") and name.endswith(".json"):
            try:
                steps.append(int(name[len("manifest-"):-len(".json")]))
            except ValueError:
                continue
    return sorted(steps)


def latest_manifest_step(directory: str) -> Optional[int]:
    """Newest step with a committed manifest (None when the directory
    has none). This is what an elastic launcher threads into the
    respawn env (``PADDLE_ELASTIC_RESUME_STEP``) — cheap, and never
    names a partially committed or quarantined step."""
    steps = _scan_manifest_steps(directory)
    return steps[-1] if steps else None


def _leaf_digest(leaf: Any) -> str:
    name, a = _host_array(leaf)
    # the JAX package hashes np.ascontiguousarray(leaf), which has at
    # least one dimension: a 0-d leaf hashes as shape (1,)
    shape = tuple(int(s) for s in a.shape) or (1,)
    h = hashlib.blake2b(digest_size=16)
    h.update(name.encode())
    h.update(str(shape).encode())
    h.update(a.reshape(-1).view(np.uint8))
    return h.hexdigest()


def digest_tree(tree: Any) -> Dict[str, str]:
    """Per-leaf blake2b digests keyed by jax-style key path, equal to
    the JAX package's ``digest_tree`` for the same tree. Leaves hash on
    a thread pool: blake2b releases the GIL over large buffers, so a
    multi-GB state hashes at several cores' rate."""
    flat = _flatten(tree)
    with ThreadPoolExecutor(_HASH_THREADS) as pool:
        digests = pool.map(_leaf_digest, [leaf for _, leaf in flat])
        return dict(zip([path for path, _ in flat], digests))


def _digest_diff(expected: Dict[str, str],
                 tree: Any) -> Dict[str, Dict[str, Any]]:
    actual = digest_tree(tree)
    diff: Dict[str, Dict[str, Any]] = {}
    for key, want in expected.items():
        got = actual.get(key)
        if got != want:
            diff[key] = {"expected": want, "actual": got}
    for key in actual:
        if key not in expected:
            diff[key] = {"expected": None, "actual": actual[key]}
    return diff


# -- step directories --------------------------------------------------------

def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_step_dir(path: str, tree: Any) -> None:
    """Commit ``tree`` as the directory ``path``: every leaf an fsynced
    ``.npy`` file plus ``tree.json`` in a tmp dir beside it, then one
    rename. A failure removes the tmp dir; a kill leaves it for the
    open-time sweep."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.{_TMP_TAG}-{os.getpid()}-{time.time_ns()}"
    os.makedirs(tmp)
    try:
        counter = [0]

        def node(x):
            if isinstance(x, dict):
                return {"dict": [[k, node(x[k])] for k in _sorted_keys(x)]}
            if isinstance(x, (list, tuple)):
                return {type(x).__name__ if type(x) in (list, tuple)
                        else "tuple": [node(v) for v in x]}
            if x is None:
                return {"none": True}
            name, a = _host_array(x)
            fname = f"leaf-{counter[0]:05d}.npy"
            counter[0] += 1
            with open(os.path.join(tmp, fname), "wb") as f:
                np.lib.format.write_array(f, a, allow_pickle=False)
                f.flush()
                os.fsync(f.fileno())
            return {"leaf": fname, "kind": _kind(x), "dtype": name}

        doc = {"format": _TREE_FORMAT, "tree": node(tree)}
        with open(os.path.join(tmp, _TREE_FILE), "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        _fsync_dir(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _read_step_dir(path: str) -> Any:
    """The tree committed at ``path``: tensors as CPU tensors, numpy
    leaves as arrays, host scalars as Python scalars."""
    index = os.path.join(path, _TREE_FILE)
    if not os.path.exists(index) and any(
            os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
        raise NotImplementedError(
            f"{path} is an orbax step directory written by the JAX "
            f"package; restoring it in the port is not supported "
            f"(ROADMAP A6.3)")
    with open(index) as f:
        doc = json.load(f)
    if doc.get("format") != _TREE_FORMAT:
        raise ValueError(f"{index}: unknown format {doc.get('format')!r}")

    def build(n):
        if "dict" in n:
            return {k: build(v) for k, v in n["dict"]}
        if "list" in n:
            return [build(v) for v in n["list"]]
        if "tuple" in n:
            return tuple(build(v) for v in n["tuple"])
        if "none" in n:
            return None
        a = np.load(os.path.join(path, n["leaf"]), allow_pickle=False)
        kind, dtype = n["kind"], n["dtype"]
        if kind == "tensor":
            t = torch.from_numpy(a)
            return t.view(torch.bfloat16) if dtype == "bfloat16" else t
        if kind == "int":
            return int(a)
        if kind == "float":
            return float(a)
        if kind == "bool":
            return bool(a)
        return a

    return build(doc["tree"])


def _place_like(tree: Any, like: Any) -> Any:
    """``tree``'s tensors moved to the device of ``like``'s matching
    leaves (the port's reading of the JAX package's target sharding)."""
    if isinstance(tree, dict) and isinstance(like, dict):
        return {k: _place_like(v, like.get(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and isinstance(like, (list, tuple)):
        return type(tree)(_place_like(v, w) for v, w in zip(tree, like))
    if isinstance(tree, torch.Tensor) and isinstance(like, torch.Tensor):
        return tree.to(like.device)
    return tree


def _snapshot(tree: Any) -> Any:
    """A host copy of ``tree`` that later in-place updates cannot tear:
    CUDA tensors copied into pinned buffers (non-blocking, then waited
    on here, before any other thread reads them), CPU tensors cloned
    (``t.cpu()`` would return ``t`` itself), numpy arrays copied."""
    cuda = []

    def snap(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cuda":
                out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                out.copy_(x, non_blocking=True)
                cuda.append(x.device)
                return out
            return x.clone(memory_format=torch.contiguous_format)
        if isinstance(x, np.ndarray):
            return np.array(x, copy=True)
        return x

    host = _tree_map(snap, tree)
    for dev in set(cuda):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
    return host


class CheckpointManager:
    """Managed step checkpoints: rotation, async save, verified
    latest/restore.

    ``save(step, tree)`` → async by default: the call stalls only for
    the device→host snapshot, then a background writer commits through
    the atomic commit + RetryPolicy path and writes the integrity
    manifest. ``restore(step=None)`` → newest VERIFIED step (digest
    mismatches quarantine the step and fall back). Restored tensors are
    CPU tensors, or on the devices of ``like``'s tensors when given.
    """

    _CLOSE = object()

    def __init__(self, directory: str, max_to_keep: int = 5,
                 async_save: bool = True,
                 retry: Optional[RetryPolicy] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = bool(async_save)
        self.retry = retry or _SAVE_RETRY
        # async writer plumbing: one queued snapshot max — a third
        # concurrent save barriers on the oldest (bounded memory: at
        # most two host snapshots alive)
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._writer: Optional[threading.Thread] = None
        self._cv = threading.Condition()
        self._pending = 0
        self._writer_err: Optional[BaseException] = None
        self._flush_timed_out = False
        # memory-ledger accounting for the host staging buffers async
        # saves hold alive (≤ 2 snapshots): a placement="host" row, so
        # /memz says why host RSS grew by a model copy mid-train.
        # _staging_bytes is guarded by _cv like the rest of the writer
        # state.
        self._staging_bytes = 0
        self._mem_scope = _memobs.next_scope()
        _memobs.finalize_scope(self, self._mem_scope)
        self._sweep_debris()

    def _note_staging(self, delta: int) -> None:
        """Adjust the ledger's view of live host staging bytes; caller
        does NOT hold _cv."""
        with self._cv:
            self._staging_bytes += delta
            nbytes = self._staging_bytes
        if _memobs.enabled():
            _memobs.set_entry(self._mem_scope, "ckpt_staging", "host",
                              nbytes, placement="host")

    # -- directory scanning -------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _disk_steps(self) -> List[int]:
        """Committed (renamed, digit-named) step data dirs."""
        steps = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            if name.isdigit() and os.path.isdir(
                    os.path.join(self.directory, name)):
                steps.append(int(name))
        return sorted(steps)

    def _manifest_steps(self) -> List[int]:
        """Verified-at-save steps: manifest present AND data committed."""
        disk = set(self._disk_steps())
        return [s for s in _scan_manifest_steps(self.directory)
                if s in disk]

    def _marker_step(self) -> Optional[int]:
        """First manifest-era step, or None when the directory has no
        era marker (pre-manifest repo, or never saved through this
        manager)."""
        try:
            with open(os.path.join(self.directory, _ERA_MARKER)) as f:
                return int(json.load(f)["first_step"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _ensure_marker(self, step: int) -> None:
        """Record (once, before the first data commit) the first
        manifest-era step: dirs below it can be legacy rollback points;
        dirs at/above it without a manifest are debris — steps are
        monotonic, so the boundary never moves."""
        path = os.path.join(self.directory, _ERA_MARKER)
        if os.path.exists(path):
            return
        os.makedirs(self.directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"first_step": int(step)}, f)
        os.replace(tmp, path)

    def _legacy_steps(self) -> List[int]:
        """Pre-manifest-era checkpoints: data dirs OLDER than the oldest
        manifest (or, in a directory with no manifests AND no era
        marker, all of them). Quarantined steps are excluded."""
        manifested = _scan_manifest_steps(self.directory)
        disk = self._disk_steps()
        if manifested:
            disk = [s for s in disk if s < manifested[0]]
        else:
            marker = self._marker_step()
            if marker is not None:
                disk = [s for s in disk if s < marker]
        return [s for s in disk if not os.path.exists(
            _manifest_path(self.directory, s) + _CORRUPT_SUFFIX)]

    def _sweep_debris(self) -> None:
        """Open-time hygiene: uncommitted tmp dirs from a hard kill
        mid-write, and (when this is a manifested directory) committed
        data dirs that never got their manifest — a kill between the
        data commit and the manifest write. Legacy steps (older than the
        oldest manifest) are left until GC rotates them out."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if _TMP_TAG in name:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        manifested = set(_scan_manifest_steps(self.directory))
        if manifested:
            # a manifest-era directory that predates the marker gets
            # one now, so debris stays classifiable
            self._ensure_marker(min(manifested))
            oldest = min(manifested)
        else:
            # marker but zero manifests: the first manifest-era commit
            # crashed before its manifest write — dirs at/above the
            # marker step are debris, never legacy rollback points. No
            # marker: pre-manifest legacy directory, not ours to sweep.
            marker = self._marker_step()
            if marker is None:
                return
            oldest = marker
        for s in self._disk_steps():
            if s >= oldest and s not in manifested \
                    and not os.path.exists(
                        _manifest_path(self.directory, s)
                        + _CORRUPT_SUFFIX):
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _read_manifest(self, step: int) -> Optional[Dict[str, Any]]:
        try:
            with open(_manifest_path(self.directory, step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_manifest(self, step: int, digests: Optional[Dict[str, str]],
                        state: Optional[Dict[str, Any]]) -> None:
        os.makedirs(self.directory, exist_ok=True)
        path = _manifest_path(self.directory, step)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"format": 1, "step": int(step),
                       "ts": time.time(), "digests": digests,
                       "state": state}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _quarantine(self, step: int) -> None:
        path = _manifest_path(self.directory, step)
        try:
            os.replace(path, path + _CORRUPT_SUFFIX)
        except OSError:
            pass

    def _delete_step(self, step: int) -> None:
        # manifest first: a kill mid-deletion must leave the step
        # UNLISTED (manifest gone) rather than listed-but-partial
        for path in (_manifest_path(self.directory, step),
                     _manifest_path(self.directory, step)
                     + _CORRUPT_SUFFIX):
            try:
                os.unlink(path)
            except OSError:
                pass
        shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _clear_debris(self, step: int) -> None:
        """Before (re)saving ``step``: drop any unmanifested or
        quarantined data dir squatting on its name."""
        if self._read_manifest(step) is not None:
            return  # a live manifested step is not debris
        if os.path.exists(self._step_dir(step)):
            self._delete_step(step)

    def _gc(self) -> None:
        """Keep the newest ``max_to_keep`` restorable steps — VERIFIED
        (manifested) ones plus any legacy pre-manifest steps at the
        migration boundary. The newest verified step is by construction
        in the keep set; quarantined steps don't count toward the budget
        and older ones are swept with the rest."""
        if not self.max_to_keep or self.max_to_keep <= 0:
            return
        restorable = sorted(set(self._manifest_steps())
                            | set(self._legacy_steps()))
        cut = restorable[-self.max_to_keep:]
        if not cut:
            return
        oldest_kept = cut[0]
        for s in self._disk_steps():
            if s < oldest_kept:
                self._delete_step(s)

    # -- save ---------------------------------------------------------------
    def _dispatch_save(self, step: int, tree: Any) -> float:
        # injection site ckpt.write: fault BEFORE the write — a retried
        # attempt never re-enters a half-written save
        if _faults.enabled():
            _faults.check("ckpt.write")
        # time the attempt itself: failed attempts and retry backoff
        # must not inflate the checkpoint_save_seconds histogram
        t0 = time.perf_counter()
        _write_step_dir(self._step_dir(step), tree)
        return time.perf_counter() - t0

    def _commit(self, step: int, tree: Any, force: bool,
                state: Optional[Dict[str, Any]]) -> bool:
        if self._read_manifest(step) is not None and not force:
            # skip, don't raise: AutoCheckpoint's multi-rank
            # agreed-older-step resume re-commits a step some ranks
            # already hold (same content)
            return False
        self._clear_debris(step)
        if force:
            self._delete_step(step)
        # marker BEFORE the first data commit: a kill in the
        # commit→manifest window must leave debris, not a fake legacy
        self._ensure_marker(step)
        # one device→host pass for the write and the digests (a no-op
        # view for the host snapshot of an async save)
        host = _tree_map(lambda x: _HostLeaf(x), tree)
        dt = self.retry.call(
            self._dispatch_save, step, host,
            describe=f"checkpoint save step {step}")
        # injection site ckpt.rename: the commit stage. A fault here
        # propagates (the caller must treat the step as unsaved) and —
        # like a real mid-commit kill — never corrupts the directory:
        # the data dir is committed but the MANIFEST was not written,
        # so latest_step() never surfaces the step and the debris is
        # swept at the next open/save
        if _faults.enabled():
            _faults.check("ckpt.rename")
        self._write_manifest(step, digest_tree(host), state)
        self._gc()
        _record_save(dt, tree)
        return True

    def _writer_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is self._CLOSE:
                return
            step, host_tree, force, state, staged = item
            try:
                # injection site ckpt.async_commit: the queued commit
                # about to run on the writer thread
                if _faults.enabled():
                    _faults.check("ckpt.async_commit")
                self._commit(step, host_tree, force, state)
            except BaseException as e:  # noqa: BLE001 — surfaced at
                with self._cv:          # the next save/barrier
                    self._writer_err = e
            finally:
                del host_tree, item     # staging buffers die with the
                self._note_staging(-staged)     # ledger row decrement
                with self._cv:
                    self._pending -= 1
                    _ckpt_metrics()["queue"].set(self._pending)
                    self._cv.notify_all()

    def _ensure_writer(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="ckpt-writer")
            self._writer.start()

    def _raise_writer_err(self) -> None:
        with self._cv:
            err, self._writer_err = self._writer_err, None
        if err is not None:
            raise err

    def save(self, step: int, tree: Any, force: bool = False,
             async_: Optional[bool] = None,
             state: Optional[Dict[str, Any]] = None) -> bool:
        """Checkpoint ``tree`` as ``step``. ``state`` (JSON-serializable)
        rides the manifest — the exact-resume bundle readable without
        restoring the arrays. ``async_`` defaults to the manager's
        ``async_save``; a failed background commit surfaces at the
        next save / ``wait_until_finished``."""
        async_ = self.async_save if async_ is None else bool(async_)
        self._raise_writer_err()
        if not async_:
            # sync: barrier any in-flight async commit (one writer at
            # a time), then commit the live tree
            self.wait_until_finished()
            return self._commit(step, tree, force, state)
        # injection site ckpt.snapshot: the only phase of an async save
        # the train loop waits on
        if _faults.enabled():
            _faults.check("ckpt.snapshot")
        t0 = time.perf_counter()
        host_tree = _snapshot(tree)
        snap_dt = time.perf_counter() - t0
        _ckpt_metrics()["snapshot"].observe(snap_dt)
        if _goodput.enabled():
            # the only phase of an async save the train loop waits on:
            # the ckpt_stall bucket of the time ledger
            _goodput.note("ckpt_stall", snap_dt)
        # ledger: this snapshot's host bytes are alive from here until
        # the writer commits (or dies trying) — the row tracks the SUM
        # over the ≤ 2 concurrently-alive snapshots
        staged = _tree_bytes(host_tree)
        self._note_staging(staged)
        self._ensure_writer()
        with self._cv:
            self._pending += 1
            _ckpt_metrics()["queue"].set(self._pending)
        # maxsize=1: blocks while another snapshot is still QUEUED —
        # the "barrier at the next save" that bounds host memory
        try:
            self._q.put((step, host_tree, force, state, staged),
                        timeout=_BARRIER_TIMEOUT_S)
        except queue.Full:
            self._note_staging(-staged)
            with self._cv:
                self._pending -= 1
                _ckpt_metrics()["queue"].set(self._pending)
            raise TimeoutError(
                f"checkpoint save step {step}: the queued commit did "
                f"not start in {_BARRIER_TIMEOUT_S:.0f} s") from None
        return True

    # -- restore ------------------------------------------------------------
    def restore(self, step: Optional[int] = None, like: Any = None,
                verify: bool = True) -> Any:
        return self.restore_with_state(step, like=like, verify=verify)[0]

    def restore_with_state(self, step: Optional[int] = None,
                           like: Any = None, verify: bool = True
                           ) -> Tuple[Any, Optional[Dict[str, Any]]]:
        """Restore a tree plus its manifest ``state`` bundle.

        ``step=None`` walks manifested steps newest→oldest and returns
        the first that passes digest verification; a mismatch
        quarantines the step (``manifest-N.json.corrupt`` — it stops
        being ``latest_step``), bumps ``ckpt_verify_failures_total``,
        and dumps a flight record carrying the digest diff. An explicit
        ``step`` raises :class:`CheckpointCorrupt` instead of falling
        back. Legacy directories (no manifests) restore unverified."""
        self.wait_until_finished()  # never race the async writer
        explicit = step is not None
        if explicit:
            candidates = [int(step)]
        else:
            candidates = list(reversed(self._manifest_steps()))
            if not candidates:
                # legacy (pre-manifest) dirs restore unverified;
                # quarantined dirs stay in the walk so an all-corrupt
                # directory raises CheckpointCorrupt, NOT the
                # FileNotFoundError auto-resume reads as "fresh start"
                quarantined = {
                    s for s in self._disk_steps() if os.path.exists(
                        _manifest_path(self.directory, s)
                        + _CORRUPT_SUFFIX)}
                candidates = sorted(
                    set(self._legacy_steps()) | quarantined,
                    reverse=True)
        last_corrupt: Optional[CheckpointCorrupt] = None
        for s in candidates:
            manifest = self._read_manifest(s)
            if manifest is None and os.path.exists(
                    _manifest_path(self.directory, s) + _CORRUPT_SUFFIX):
                # quarantined: the data dir is forensics, not a legacy
                # step — an explicit restore must raise, not hand back
                # known-corrupt arrays unverified
                err = CheckpointCorrupt(s, {"<manifest>": {
                    "expected": "committed manifest",
                    "actual": "quarantined (" + _MANIFEST_FMT.format(
                        step=s) + _CORRUPT_SUFFIX + ")"}})
                if explicit:
                    raise err
                last_corrupt = err
                continue
            t0 = time.perf_counter()
            try:
                if not os.path.isdir(self._step_dir(s)):
                    raise FileNotFoundError(self._step_dir(s))
                tree = _read_step_dir(self._step_dir(s))
            except FileNotFoundError:
                if explicit:
                    raise
                continue  # dir vanished under the walk (racing GC)
            except NotImplementedError:
                raise  # another package's format: not corruption
            except Exception as e:  # noqa: BLE001
                # corruption severe enough that the step can't even be
                # read (truncated files, a mangled header or index):
                # same verdict as a digest mismatch
                err = CheckpointCorrupt(
                    s, {"<restore>": {"expected":
                                      "readable checkpoint data",
                                      "actual": repr(e)}})
                if manifest is None:
                    # legacy dir (no verification contract): raise for
                    # an explicit request, but never let one unreadable
                    # dir end the step=None fallback walk
                    if explicit:
                        raise
                    last_corrupt = err
                    continue
                self._on_verify_failure(s, err.diff)
                if explicit:
                    raise err from e
                last_corrupt = err
                continue
            dt = time.perf_counter() - t0
            digests = (manifest or {}).get("digests")
            if verify and digests is not None:
                diff = _digest_diff(digests, tree)
                if diff:
                    err = CheckpointCorrupt(s, diff)
                    self._on_verify_failure(s, diff)
                    if explicit:
                        raise err
                    last_corrupt = err
                    continue
            _record_restore(dt)
            if like is not None:
                tree = _place_like(tree, like)
            return tree, (manifest or {}).get("state")
        if last_corrupt is not None:
            raise last_corrupt
        raise FileNotFoundError(
            f"no checkpoints under {self.directory}")

    def _on_verify_failure(self, step: int,
                           diff: Dict[str, Dict[str, Any]]) -> None:
        _ckpt_metrics()["verify_fail"].inc()
        stat_add("checkpoint.verify_failures")
        self._quarantine(step)
        # flight-recorder dump with the digest diff attached (no-op
        # unless a recorder is installed)
        try:
            from ..observability.flight import dump_flight_record
            dump_flight_record(
                f"ckpt_verify_step{step}",
                extra={"what": "checkpoint_verify_failure",
                       "directory": self.directory, "step": int(step),
                       "digest_diff": dict(
                           sorted(diff.items())[:16])})
        except Exception:  # noqa: BLE001 — never mask the corruption
            pass

    # -- introspection / lifecycle ------------------------------------------
    def verified_steps(self) -> List[int]:
        """Manifested, non-quarantined steps oldest→newest — the
        restore candidates ``restore_with_state(None)`` walks in
        reverse, and the rollback points of the numeric guard."""
        return self._manifest_steps()

    def latest_step(self) -> Optional[int]:
        """Newest step safe to resume from: manifested (commit
        completed) and not quarantined. Falls back to raw committed
        dirs only for legacy (pre-manifest) directories."""
        steps = self._manifest_steps()
        if steps:
            return steps[-1]
        legacy = self._legacy_steps()  # never a quarantined dir
        return legacy[-1] if legacy else None

    def all_steps(self):
        return self._disk_steps()

    def read_state(self, step: int) -> Optional[Dict[str, Any]]:
        """The manifest ``state`` bundle without restoring arrays."""
        manifest = self._read_manifest(step)
        return None if manifest is None else manifest.get("state")

    def wait_until_finished(self) -> None:
        """Barrier: block until in-flight async commits finish; raises
        any background commit failure."""
        with self._cv:
            self._wait_drained("wait_until_finished")
            # a drained queue un-abandons the manager: a survived
            # flush timeout must not make close() skip its barrier
            self._flush_timed_out = False
        self._raise_writer_err()

    def _wait_drained(self, what: str) -> None:
        """With ``_cv`` held: wait until no commit is pending, at most
        ``_BARRIER_TIMEOUT_S``."""
        if not self._cv.wait_for(lambda: not self._pending,
                                 timeout=_BARRIER_TIMEOUT_S):
            raise TimeoutError(
                f"checkpoint {what}: the writer did not finish "
                f"{self._pending} pending commit(s) in "
                f"{_BARRIER_TIMEOUT_S:.0f} s ({self.directory})")

    def flush(self, deadline=None) -> str:
        """Deadline-budgeted barrier for the preemption path: wait for
        in-flight async commits only as long as the grace budget
        allows. Returns the outcome — ``"committed"`` (everything
        durable), ``"timeout"`` (budget ran out first; the previous
        manifested step stands), ``"noop"`` (nothing in flight), or
        ``"error"`` (a background commit failed) — and counts it in
        ``ckpt_emergency_flush_total{outcome=}``."""
        dl = as_deadline(deadline)
        outcome = "committed"
        t0 = time.perf_counter()
        with self._cv:
            if not self._pending:
                outcome = "noop" if self._writer_err is None else "error"
            while self._pending:
                remaining = None if dl is None else dl.remaining()
                if remaining is not None and remaining <= 0:
                    outcome = "timeout"
                    # the grace budget is SPENT: the teardown that
                    # follows (fit's finally → close()) must not
                    # re-block on the same stuck commit
                    self._flush_timed_out = True
                    break
                self._cv.wait(timeout=remaining)
            if outcome == "committed" and self._writer_err is not None:
                outcome = "error"
        _ckpt_metrics()["flush"].labels(outcome).inc()
        stat_add(f"checkpoint.flush_{outcome}")
        if _goodput.enabled():
            # the emergency-flush barrier is grace budget spent NOT
            # training: ckpt_stall on the time ledger
            _goodput.note("ckpt_stall", time.perf_counter() - t0)
        return outcome

    def close(self) -> None:
        if self._flush_timed_out:
            # best-effort teardown after a timed-out emergency flush:
            # never wait on the in-flight commit again (a half-written
            # commit is unmanifested debris, swept at the next open);
            # the daemon writer dies with the exiting process
            try:
                self._q.put_nowait(self._CLOSE)
            except queue.Full:
                pass
            return
        if self._writer is not None and self._writer.is_alive():
            with self._cv:
                self._wait_drained("close")
            self._q.put(self._CLOSE, timeout=_BARRIER_TIMEOUT_S)
            self._writer.join(timeout=30.0)
        self._raise_writer_err()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_checkpoint(path: str, model, optimizer_state=None,
                    step: int = 0, **extra) -> None:
    """One-shot full-training-state save (model + opt state + counters)
    — the dygraph ``paddle.save({'model': ..., 'opt': ...})`` idiom,
    committed atomically as the step directory ``path``."""
    tree = {"model": dict(model.state_dict()),
            "step": np.asarray(step)}
    if optimizer_state is not None:
        tree["optimizer"] = optimizer_state
    tree.update(extra)
    box = {}

    def _dispatch():
        if _faults.enabled():
            _faults.check("ckpt.write")
        # successful-attempt clock: retries/backoff stay out of the
        # recorded save duration
        box["t0"] = time.perf_counter()
        _write_step_dir(path, tree)

    _SAVE_RETRY.call(_dispatch, describe=f"save_checkpoint {path}")
    if _faults.enabled():
        _faults.check("ckpt.rename")
    _record_save(time.perf_counter() - box["t0"], tree)


def load_checkpoint(path: str, model=None, like: Any = None) -> Dict:
    """Restore a :func:`save_checkpoint` artifact; if ``model`` is given
    its state dict is copied in place (ref: paddle.load +
    set_state_dict)."""
    t0 = time.perf_counter()
    tree = _read_step_dir(os.path.abspath(path))
    if like is not None:
        tree = _place_like(tree, like)
    _record_restore(time.perf_counter() - t0)
    if model is not None and "model" in tree:
        model.load_state_dict(tree["model"])
    return tree


class AutoCheckpoint:
    """Epoch-granular automatic checkpoint/resume
    (ref: fluid/incubate/checkpoint/auto_checkpoint.py:267
    TrainEpochRange — snapshots state keyed by job id and skips
    already-trained epochs after a restart).

    Usage::
        acp = AutoCheckpoint(dir, model)
        for epoch in acp.epochs(total):   # resumes mid-range on restart
            ... train ...
            acp.commit(epoch)             # snapshot + advance
    """

    def __init__(self, directory: str, model, optimizer_state_fn=None,
                 optimizer_restore_fn=None, max_to_keep: int = 2):
        self.model = model
        self.optimizer_state_fn = optimizer_state_fn
        self.optimizer_restore_fn = optimizer_restore_fn
        self.mgr = CheckpointManager(directory, max_to_keep=max_to_keep,
                                     async_save=False)

    @classmethod
    def for_model(cls, directory: str, model, max_to_keep: int = 2):
        """AutoCheckpoint over a hapi ``Model``: snapshots the network
        params AND the optimizer state + step counter, restores both
        into the live tensors — the full lossless-resume bundle (pairs
        with ``distributed.elastic.PreemptionGuard`` for the SIGTERM →
        checkpoint → restart flow)."""

        def state_fn():
            return {"opt": model._full_opt_state(),
                    "step_count": int(model._step_count)}

        def restore_fn(tree):
            model._load_opt_state(tree["opt"])
            model._step_count = int(tree["step_count"])

        return cls(directory, model.network, optimizer_state_fn=state_fn,
                   optimizer_restore_fn=restore_fn,
                   max_to_keep=max_to_keep)

    def epochs(self, total: int, agree_step=None):
        """Resume-aware epoch/step range.

        ``agree_step`` (optional) maps this process's latest committed
        step (-1 if none) to the step EVERY process will resume from —
        in a multi-process job a hard kill can land between ranks'
        commits, leaving per-rank checkpoint dirs one step apart. Pass a
        global MIN so all ranks restore the same step; keep
        ``max_to_keep`` ≥ 2 so the agreed step is still on disk."""
        start = self.mgr.latest_step()
        if agree_step is not None:
            local = -1 if start is None else start
            agreed = int(agree_step(local))
            if agreed > local:
                raise RuntimeError(
                    f"agreed resume step {agreed} is ahead of local "
                    f"checkpoints (latest {start}) — agree_step must "
                    f"be a global MIN")
            start = None if agreed < 0 else agreed
        first = 0 if start is None else start + 1
        if first > 0:
            tree = self.mgr.restore(start)
            self.model.load_state_dict(tree["model"])
            if "optimizer" in tree:
                if self.optimizer_restore_fn is None:
                    raise ValueError(
                        "checkpoint contains optimizer state but no "
                        "optimizer_restore_fn was given — resuming would "
                        "silently reset Adam moments/schedule counters")
                self.optimizer_restore_fn(tree["optimizer"])
        for e in range(first, total):
            yield e

    def commit(self, epoch: int) -> None:
        tree = {"model": dict(self.model.state_dict())}
        if self.optimizer_state_fn is not None:
            tree["optimizer"] = self.optimizer_state_fn()
        self.mgr.save(epoch, tree)
        self.mgr.wait_until_finished()
