"""Checkpoint/resume: local snapshots with ``torch.save`` (ported from
``distributedvolunteercomputing_tpu/training/checkpoint.py``, which uses
orbax).

Volunteer churn only makes sense if a stopped volunteer can come back
(preemption -> restart on a fresh machine): ``save`` flushes the full train
state (params, optimizer moments, step, the step generator's state; a
frozen leaf's moment slots are None, ``training/optim.py``),
``maybe_restore`` loads the newest snapshot if one exists. Peer-pull resume
(fetching newer params from live peers after a long absence) lives in
swarm.state_sync.

Layout, as the reference's: ``<ckpt_dir>/step_N/`` per snapshot, here
holding one ``state.pt`` of CPU tensors, with the optional ``.outer.npz``
and ``.wire.npz`` sidecars beside the directory. A snapshot is written into
a temporary directory whose name ``latest_step`` ignores and renamed into
place, so a reader never sees a torn one. A mesh trainer's snapshot holds
each leaf assembled from its slices (the same file a one-rank trainer
writes), and its restore writes each rank's slice of the host trees
straight into the live tensors, never building the whole state on one rank.

A zone-sharded volunteer also snapshots the shard slices it owns
(``save_shard_snapshot``: one ``.npy`` per shard and a ``meta.json``, as the
reference writes them); ``assemble_full`` rebuilds the flat buffer from a
zone's snapshots.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from distributedvolunteercomputing_tpu_torch.parallel.sharding import ShardedTensor
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger
from distributedvolunteercomputing_tpu_torch.utils.pytree import torch_dtype, tree_leaves

log = get_logger(__name__)

_STEP_RE = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"


def _to_host(obj: Any) -> Any:
    """A host COPY of a tree of tensors (dicts, lists, scalars). Never a
    view: on the CPU a view aliases the live tensor the next step updates
    in place, and the writer thread would serialize a moving target. A
    mesh leaf is assembled from its slices."""
    if isinstance(obj, ShardedTensor):
        return obj.full("cpu")
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_host(v) for v in obj]
    return obj


def _cast_floating(obj: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor of a tree (dicts, lists, scalars) cast to ``dtype``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return {k: _cast_floating(v, dtype) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_cast_floating(v, dtype) for v in obj]
    return obj


def _sharded(trainer) -> bool:
    return getattr(trainer, "mesh", None) is not None


def _state_to_host(trainer) -> dict:
    state = trainer.state
    return {
        "params": _to_host(state.params),
        "opt_state": _to_host(state.opt_state),
        "step": int(state.step),
        "rng": state.rng.get_state(),  # already a CPU copy; rank 0's on a mesh
    }


# Snapshots kept per directory after a save (DVC_CKPT_KEEP overrides).
# Periodic saves otherwise grow without bound: at gpt2_small scale each
# snapshot is ~1.5 GB (params + AdamW moments), and a long volunteer run
# with --checkpoint-every 200 would fill the disk.
def _keep_last() -> int:
    raw = os.environ.get("DVC_CKPT_KEEP", "3")
    try:
        return int(raw)
    except ValueError:
        log.warning("DVC_CKPT_KEEP=%r is not an integer; keeping 3", raw)
        return 3


KEEP_LAST = _keep_last()


def _gc(ckpt_dir: str, just_saved: int, keep: int = 0) -> None:
    """Delete all but the newest ``keep`` snapshots (by step number), never
    touching steps >= the snapshot just written — stale HIGHER-step entries
    (a reused directory, a second volunteer lagging behind) must not make GC
    eat the save that just happened."""
    keep = keep or KEEP_LAST
    if not os.path.isdir(ckpt_dir) or keep <= 0:
        return
    steps = sorted(
        int(m.group(1)) for name in os.listdir(ckpt_dir) if (m := _STEP_RE.match(name))
    )
    for step in steps[:-keep]:
        if step >= just_saved:
            continue
        path = os.path.join(ckpt_dir, f"step_{step}")
        try:
            shutil.rmtree(path)
            # The sidecars live BESIDE the snapshot dir.
            for sidecar in (_outer_state_path(path), _wire_state_path(path)):
                if os.path.exists(sidecar):
                    os.remove(sidecar)
            log.info("checkpoint GC: removed %s", path)
        except OSError as e:
            log.warning("checkpoint GC failed for %s: %s", path, errstr(e))


def _outer_state_path(snapshot_path: str) -> str:
    # Beside (not inside) the snapshot directory, as the reference keeps it.
    return snapshot_path + ".outer.npz"


def _save_outer_state(trainer, snapshot_path: str) -> None:
    """Persist the outer optimizer's anchor and momentum beside the snapshot
    as flat f32 buffers (``anchor``, ``m``), the reference's format: a
    preemption then keeps the outer momentum instead of re-seeding it. A
    no-op without an outer optimizer or before its first round."""
    anchor = getattr(trainer, "_outer_anchor", None)
    if getattr(trainer, "outer_optimizer", "none") == "none" or anchor is None:
        return
    from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer

    buf_a, _, _ = flatten_to_buffer(anchor)
    buf_m, _, _ = flatten_to_buffer(trainer._outer_m)
    try:
        np.savez(_outer_state_path(snapshot_path), anchor=buf_a, m=buf_m)
    except OSError as e:
        log.warning("outer-state save failed (continuing): %s", errstr(e))


def _wire_state_path(snapshot_path: str) -> str:
    # Same beside-the-snapshot policy as the outer-state sidecar.
    return snapshot_path + ".wire.npz"


def _save_wire_state(trainer, snapshot_path: str) -> None:
    """Persist the averager's compressor state beside the snapshot: the
    topk and sign wires' error-feedback residual and PowerSGD's warm Q (the
    f32, bf16 and q8 wires are stateless and write none). The volunteer
    attaches its averager as ``trainer._wire_averager``; library users
    without a swarm have no sidecar."""
    avg = getattr(trainer, "_wire_averager", None)
    if avg is None:
        return
    try:
        state = avg.wire_state()
    except Exception as e:  # noqa: BLE001 — sidecar must never kill a save
        log.warning("wire-state snapshot failed (continuing): %s", errstr(e))
        return
    if not state:
        return
    try:
        np.savez(_wire_state_path(snapshot_path), **state)
    except OSError as e:
        log.warning("wire-state save failed (snapshot is intact): %s", errstr(e))


def _maybe_restore_wire_state(trainer, snapshot_path: str) -> None:
    """Hand the sidecar back to the averager, which validates it against its
    schema at first pack and re-seeds on a mismatch."""
    avg = getattr(trainer, "_wire_averager", None)
    if avg is None:
        return
    path = _wire_state_path(snapshot_path)
    if not os.path.exists(path):
        return
    try:
        with np.load(path) as d:
            avg.load_wire_state({k: d[k] for k in d.files})
        log.info("restored averager wire state from %s", path)
    except (OSError, ValueError, KeyError) as e:
        log.warning("wire-state restore failed (re-seeding): %s", errstr(e))


def _maybe_restore_outer_state(trainer, snapshot_path: str) -> None:
    """Rebuild anchor/momentum from the sidecar if it matches the current
    payload schema; silently absent otherwise (the next round re-seeds)."""
    if getattr(trainer, "outer_optimizer", "none") == "none":
        return
    path = _outer_state_path(snapshot_path)
    if not os.path.exists(path):
        return
    from distributedvolunteercomputing_tpu_torch.utils.pytree import (
        tree_specs,
        unflatten_from_buffer,
    )

    specs, treedef = tree_specs(trainer.bundle.avg_select(trainer.state.params))
    expect = int(sum(s.size for s in specs))
    try:
        with np.load(path) as d:
            buf_a, buf_m = d["anchor"], d["m"]
    except (OSError, ValueError, KeyError) as e:
        log.warning("outer-state restore failed (re-seeding): %s", errstr(e))
        return
    if buf_a.size != expect or buf_m.size != expect:
        log.warning("outer-state size %d != payload schema %d; re-seeding", buf_a.size, expect)
        return
    trainer._outer_anchor = unflatten_from_buffer(buf_a, specs, treedef, device=None)
    trainer._outer_m = unflatten_from_buffer(buf_m, specs, treedef, device=None)
    log.info("restored outer-optimizer state from %s", path)


def _write_snapshot(host_tree: dict, ckpt_dir: str, step: int) -> str:
    """``host_tree`` into ``<ckpt_dir>/step_<step>/state.pt``: written in a
    temporary directory, then renamed into place (an existing snapshot of
    the same step is replaced)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = os.path.join(os.path.dirname(path), f".step_{step}.{tag}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        torch.save(host_tree, os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            old = os.path.join(os.path.dirname(path), f".step_{step}.{tag}.old")
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path


def _host_copy(trainer) -> dict:
    """The host copy, timed on the caller's (trainer) thread."""
    t0 = time.perf_counter()
    host_tree = _state_to_host(trainer)
    ms = (time.perf_counter() - t0) * 1e3
    trainer.metrics.record_event(host_tree["step"], "ckpt_host_copy", {"ms": ms})
    return host_tree


def save(trainer, ckpt_dir: str) -> str:
    host_tree = _host_copy(trainer)
    step = host_tree["step"]
    t0 = time.perf_counter()
    path = _write_snapshot(host_tree, ckpt_dir, step)
    _save_outer_state(trainer, path)
    _save_wire_state(trainer, path)
    trainer.metrics.record_event(step, "ckpt_saved", {"write_s": time.perf_counter() - t0, "path": path})
    log.info("checkpoint saved: %s", path)
    _gc(ckpt_dir, just_saved=step)
    return path


def save_async(trainer, ckpt_dir: str) -> bool:
    """Periodic-save path: snapshot to HOST on the caller's thread (one copy
    per tensor, never a view), then write the file on a background thread
    so the device never idles on disk I/O. At most one save in flight PER
    TRAINER — if its previous write is still running, skip this point (the
    next cadence retries; a skipped periodic save just widens one interval).
    The FINAL save at exit must drain via ``wait_pending_saves`` and then use
    ``save``. Returns True if a save was started."""
    prev = getattr(trainer, "_ckpt_writer", None)
    if prev is not None and prev.is_alive():
        log.info("checkpoint still writing; skipping this save point")
        return False
    host_tree = _host_copy(trainer)
    # Record WHICH state this snapshot is (step + out-of-band mutation
    # count), so the final-save path can tell "already saved" apart from
    # "same step number but params mutated since" (end-of-run merge).
    trainer._ckpt_snapshot_id = (host_tree["step"], getattr(trainer, "mutation_counter", 0))
    step = host_tree["step"]

    # Outer-optimizer state is snapshotted on the CALLER thread too (host
    # numpy mutated only between steps on this same thread).
    outer_bufs = None
    if getattr(trainer, "outer_optimizer", "none") != "none" and getattr(trainer, "_outer_anchor", None) is not None:
        from distributedvolunteercomputing_tpu_torch.utils.pytree import flatten_to_buffer

        outer_bufs = (flatten_to_buffer(trainer._outer_anchor)[0], flatten_to_buffer(trainer._outer_m)[0])
    # Compressor state snapshotted on the caller thread too (wire_state
    # copies arrays that the averager only ever replaces wholesale).
    wire_snapshot = None
    if getattr(trainer, "_wire_averager", None) is not None:
        try:
            wire_snapshot = trainer._wire_averager.wire_state()
        except Exception as e:  # noqa: BLE001
            log.warning("wire-state snapshot failed (continuing): %s", errstr(e))

    def _write():
        t0 = time.perf_counter()
        try:
            path = _write_snapshot(host_tree, ckpt_dir, step)
        except Exception as e:  # noqa: BLE001 — a failed periodic save must not kill training
            log.warning("async checkpoint save failed: %s", errstr(e))
            return
        # Sidecar failure must not mislabel the landed snapshot as failed,
        # and must never skip GC (that's how a disk fills).
        if outer_bufs is not None:
            try:
                np.savez(_outer_state_path(path), anchor=outer_bufs[0], m=outer_bufs[1])
            except OSError as e:
                log.warning("outer-state save failed (snapshot is intact): %s", errstr(e))
        if wire_snapshot:
            try:
                np.savez(_wire_state_path(path), **wire_snapshot)
            except OSError as e:
                log.warning("wire-state save failed (snapshot is intact): %s", errstr(e))
        trainer.metrics.record_event(
            step, "ckpt_saved", {"write_s": time.perf_counter() - t0, "path": path, "async": True}
        )
        log.info("checkpoint saved (async): %s", path)
        _gc(ckpt_dir, just_saved=step)

    t = threading.Thread(target=_write, name="ckpt-writer", daemon=True)
    trainer._ckpt_writer = t
    t.start()
    return True


def wait_pending_saves(trainer, hard_cap: float = 600.0) -> bool:
    """Block until THIS trainer's in-flight async save lands. Returns True
    when nothing is in flight anymore; False if the writer is still alive
    after ``hard_cap`` (e.g. dead NFS) — in that case the caller must NOT
    write the same directory, and should skip its synchronous save."""
    t = getattr(trainer, "_ckpt_writer", None)
    if t is None or not t.is_alive():
        return True
    deadline = time.monotonic() + hard_cap
    while t.is_alive():
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            log.error(
                "async checkpoint writer still running after %.0fs; "
                "skipping the conflicting synchronous save", hard_cap,
            )
            return False
        t.join(min(remaining, 10.0))
    return True


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir) if (m := _STEP_RE.match(name))]
    return max(steps) if steps else None


def _copy_into(dst: Any, src: Any, what: str, device: Optional[torch.device] = None) -> None:
    """Copy a loaded tree into the live one in place (casting to the live
    dtype), refusing a structure or shape that differs. A list slot may be
    None on either side (optimizer moments not made yet, ``training/optim.py``):
    a copy of the loaded tensor on ``device``, or None, takes the slot."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint {what}: {getattr(src, 'shape', type(src))} != live {tuple(dst.shape)}")
        dst.copy_(src)
    elif isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(f"checkpoint {what}: keys differ from the live state")
        for k in dst:
            if isinstance(dst[k], (torch.Tensor, dict, list)):
                _copy_into(dst[k], src[k], f"{what}/{k}", device)
            else:
                dst[k] = src[k]
    elif isinstance(dst, list):
        if not isinstance(src, (list, tuple)) or len(src) != len(dst):
            raise ValueError(f"checkpoint {what}: length differs from the live state")
        for i, (d, s) in enumerate(zip(dst, src)):
            if d is None or s is None:
                if not (s is None or isinstance(s, torch.Tensor)):
                    raise ValueError(f"checkpoint {what}[{i}]: {type(s)} in a moment slot")
                dst[i] = None if s is None else s.to(device, copy=True)
            else:
                _copy_into(d, s, f"{what}[{i}]", device)
    else:
        raise TypeError(f"checkpoint {what}: cannot restore into {type(dst)}")


def _restore_sharded(state, params: Any, opt_state: Any, step: int, rng_state: torch.Tensor) -> None:
    """Host trees onto a ``ShardedTrainState``: each rank's slice of each
    leaf written into its tensor, moments made on their placement where
    the live state has none yet."""
    from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_flatten

    live, live_def = tree_flatten(state.params)
    host, host_def = tree_flatten(params)
    if live_def != host_def:
        raise ValueError("checkpoint params: keys differ from the live state")
    for dst, src in zip(live, host):
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint params: {tuple(src.shape)} != live {tuple(dst.shape)}")
        dst.write(src)
    if set(opt_state) != set(state.opt_state):
        raise ValueError("checkpoint opt_state: keys differ from the live state")
    for name, v in opt_state.items():
        if not isinstance(v, (list, tuple)):
            state.opt_state[name] = v
            continue
        slots = state.opt_state[name]
        if len(v) != len(slots):
            raise ValueError(f"checkpoint opt_state/{name}: length differs from the live state")
        for i, (m, sh, leaf) in enumerate(zip(v, state.opt_shardings, live)):
            if m is None:
                slots[i] = None
            elif slots[i] is None:
                slots[i] = ShardedTensor.place(sh, m, leaf.dtype)
            else:
                slots[i].write(m)
    state.step = step
    for rng in state.rngs:
        rng.set_state(rng_state)


def maybe_restore(trainer, ckpt_dir: str) -> bool:
    """Load the newest snapshot into the trainer, if any. Returns True if restored."""
    step = latest_step(ckpt_dir)
    if step is None:
        return False
    t0 = time.perf_counter()
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    # A mesh trainer reads the host trees and places each rank's slice.
    restored = torch.load(os.path.join(path, STATE_FILE), map_location="cpu" if _sharded(trainer) else trainer.device,
                          weights_only=True)
    params, opt_state = restored["params"], restored["opt_state"]
    if getattr(trainer, "param_dtype", None):
        # Re-apply the CONFIGURED dtype over whatever the snapshot holds:
        # a snapshot taken before a fleet-wide --param-dtype change would
        # otherwise restore the old dtype, flip this volunteer's averaging
        # schema hash away from its peers', and strand it training solo.
        dt = torch_dtype(trainer.param_dtype)
        params, opt_state = _cast_floating(params, dt), _cast_floating(opt_state, dt)
    rng_state = restored["rng"].to("cpu")
    with torch.no_grad():
        if _sharded(trainer):
            _restore_sharded(trainer.state, params, opt_state, int(restored["step"]), rng_state)
        else:
            state = trainer.state
            _copy_into(state.params, params, "params")
            _copy_into(state.opt_state, opt_state, "opt_state", tree_leaves(state.params)[0].device)
            state.step = int(restored["step"])
            state.rng.set_state(rng_state)
    _maybe_restore_outer_state(trainer, path)
    _maybe_restore_wire_state(trainer, path)
    # Refresh the cross-thread snapshot: the state-sync provider must
    # announce/serve the RESTORED step, not the cold init from __init__.
    trainer._take_snapshot(step)
    restore_s = time.perf_counter() - t0
    trainer.metrics.record_event(step, "ckpt_restored", {"restore_s": restore_s, "path": path})
    log.info("restored checkpoint step %d from %s (%.2fs)", step, path, restore_s)
    return True


# -- sharded snapshots (zone-sharded training, swarm/sharding.py) ------------
#
# A sharded volunteer snapshots its OWN shard slices (one .npy per shard plus
# a json meta carrying the fenced map generation), and a zone's worth of
# shard snapshots reassembles into the full flat buffer. Plain numpy files,
# as the reference's: a shard is one contiguous f32 slice with no tree
# structure. They exist so a cold-started zone (every holder gone at once,
# the one case the recovery ladder cannot close) resumes from local disk.


def save_shard_snapshot(ckpt_dir: str, store, smap, step: int) -> str:
    """Write every OWNED shard slice + meta under ``ckpt_dir/shards/``.
    Returns the snapshot directory. Meta pins (k, gen, zone members) so a
    restore into a differently-cut world is refused loudly."""
    import json

    d = os.path.join(ckpt_dir, "shards", f"step_{int(step):010d}")
    os.makedirs(d, exist_ok=True)
    owned = []
    for s in store.held():
        arr = store.get(s, allow_replica=False)
        if arr is None:
            continue
        np.save(os.path.join(d, f"shard_{s}.npy"), np.asarray(arr, np.float32))
        owned.append(int(s))
    meta = {
        "step": int(step),
        "k": int(smap.k),
        "gen": int(smap.gen),
        "domain": smap.domain,
        "members": list(smap.members),
        "owned": owned,
    }
    with open(os.path.join(d, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    log.info("saved shard snapshot step %d (%d shard(s)) to %s", step, len(owned), d)
    return d


def load_shard_snapshot(snap_dir: str, k: int) -> dict:
    """Load one holder's shard snapshot: {"meta": ..., "shards": {s: arr}}.
    Refuses a snapshot cut for a different K: shard ranges depend only on
    (n_elems, K), so a K mismatch means the slices are not the same tensor
    regions."""
    import json

    with open(os.path.join(snap_dir, "meta.json")) as fh:
        meta = json.load(fh)
    if int(meta.get("k", -1)) != int(k):
        raise ValueError(
            f"shard snapshot k={meta.get('k')} != configured k={k}: "
            "refusing a differently-cut restore"
        )
    shards = {}
    for s in meta.get("owned", []):
        p = os.path.join(snap_dir, f"shard_{int(s)}.npy")
        if os.path.exists(p):
            shards[int(s)] = np.load(p)
    return {"meta": meta, "shards": shards}


def assemble_full(snap_dirs, n_elems: int, k: int) -> np.ndarray:
    """Reassemble the full flat buffer from a zone's shard snapshots (one
    directory per holder; later directories win ties). Raises if any shard
    range is missing: a partial assembly is not a model."""
    from distributedvolunteercomputing_tpu_torch.swarm.sharding import shard_ranges

    ranges = shard_ranges(int(n_elems), int(k))
    buf = np.zeros(int(n_elems), np.float32)
    got = set()
    for d in snap_dirs:
        snap = load_shard_snapshot(d, k)
        for s, arr in snap["shards"].items():
            lo, hi = ranges[s]
            if arr.size != hi - lo:
                raise ValueError(
                    f"shard {s} snapshot has {arr.size} elems, range needs {hi - lo}"
                )
            buf[lo:hi] = arr
            got.add(s)
    missing = [s for s in range(k) if s not in got]
    if missing:
        raise ValueError(f"shard snapshot set is missing shard(s) {missing}")
    return buf
