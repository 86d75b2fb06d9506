"""Training checkpoint/resume for whole train states (port of
paddle_tpu/checkpoint.py, its npz writer).

The unit of checkpointing is a state: the port's `TrainState`
(`models/train.py`) or any nest of dicts, lists, tuples and dataclasses
whose leaves are tensors, numpy arrays, Python numbers or a
`torch.Generator`.  Each leaf is stored in one `arrays.npz` under the
key the reference gives the matching leaf of its pytree
(`jax.tree_util.keystr`: `.params['fc.weight']`, `.opt_state['__step__']`,
`['a'][0]`), so the two packages' files line up; bfloat16 is written as
the reference writes it (raw 2-byte words, `interop.save_npz`).  A
generator is stored as its `get_state()` bytes and comes back as a new
generator on the template's device with that state, which is what makes
a resumed dropout run bitwise equal to the uninterrupted one.  A
reference checkpoint's PRNG key is the one leaf that does not cross: the
template's generator is kept for it.

Crash safety is the reference's protocol: a step directory
(`step_<n>`) counts only once its `_COMPLETE` marker exists, written
last; before it a `_MANIFEST.json` records the size and crc32 of every
payload file (`state/arrays.npz`, `extras.npz`, `sparse_tables.npz`,
`_TOPOLOGY.json`), and `latest_step` skips a markered step whose bytes
no longer match, falling back to the previous complete one.
`CheckpointManager` keeps the last `max_to_keep` and removes crashed
attempts older than the newest complete step.

Not here: the orbax writer (JAX only; `writer="orbax"`, and loading a
step that holds only an orbax checkpoint, raise), the resharded restore
onto another mesh (ROADMAP item 8), and the monitor counters, the
goodput ledger and the fault-injection points (item 10).
"""

import dataclasses
import json
import os
import re
import shutil
import socket
import time
import zlib

import numpy as np
import torch

from .interop import from_numpy_exact, save_npz, to_numpy_exact

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "load_extras", "load_topology", "restore_resharded",
           "resharded_cursor", "CheckpointManager"]

_STEP_DIR = re.compile(r"^step_(\d+)$")
_MARKER = "_COMPLETE"
_MANIFEST = "_MANIFEST.json"
_TOPOLOGY = "_TOPOLOGY.json"

# verification memo: abs step path -> (manifest mtime_ns, payload stat
# signature, ok); a training loop calls latest_step via _gc on every save
_verify_memo = {}


# -- the reference's pytree paths over torch states --------------------------

def _is_leaf(x):
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float,
                          bool, torch.Generator))


def _children(node):
    """[(path component, child)] of a container, in the reference's
    flatten order (dict keys sorted, as jax sorts them)."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    raise TypeError(f"checkpoint: cannot flatten a {type(node).__name__}")


def flatten_with_path(state, prefix=""):
    """[(keystr, leaf)] of `state` (None subtrees have no leaves)."""
    if state is None:
        return []
    if _is_leaf(state):
        return [(prefix, state)]
    out = []
    for part, child in _children(state):
        out.extend(flatten_with_path(child, prefix + part))
    return out


def _rebuild(node, prefix, leaf_fn):
    if node is None:
        return None
    if _is_leaf(node):
        return leaf_fn(prefix, node)
    if isinstance(node, dict):
        return {k: _rebuild(node[k], f"{prefix}[{k!r}]", leaf_fn)
                for k in node}
    if isinstance(node, (list, tuple)):
        vals = [_rebuild(c, f"{prefix}[{i}]", leaf_fn)
                for i, c in enumerate(node)]
        return type(node)(vals) if isinstance(node, list) else tuple(vals)
    return dataclasses.replace(node, **{
        f.name: _rebuild(getattr(node, f.name), f"{prefix}.{f.name}",
                         leaf_fn)
        for f in dataclasses.fields(node)})


def _leaf_array(v):
    if isinstance(v, torch.Generator):
        return v.get_state().numpy()
    if isinstance(v, torch.Tensor):
        return to_numpy_exact(v)
    return np.asarray(v)


def _restore_leaf(tmpl, a):
    """The stored array `a` in the place of template leaf `tmpl`."""
    if isinstance(tmpl, torch.Generator):
        if a.dtype != np.uint8:
            # a PRNG key of the reference: no torch counterpart
            return tmpl
        g = torch.Generator(device=tmpl.device)
        g.set_state(torch.from_numpy(np.array(a)))
        return g
    if isinstance(tmpl, torch.Tensor):
        return from_numpy_exact(a).to(tmpl.device)
    if isinstance(tmpl, np.ndarray):
        return np.array(a)
    return type(tmpl)(np.asarray(a).item()) if np.ndim(a) == 0 else a


# -- the marker / manifest protocol (the reference's) -------------------------

def _iter_payload_files(path):
    """Every file under the step dir except the marker/manifest
    themselves, as (relpath, abspath) in sorted order."""
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for f in sorted(files):
            if root == path and f in (_MARKER, _MANIFEST):
                continue
            ap = os.path.join(root, f)
            yield os.path.relpath(ap, path), ap


def _file_crc32(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return crc
            crc = zlib.crc32(b, crc)


def _write_manifest(path):
    entries = {}
    for rel, ap in _iter_payload_files(path):
        entries[rel] = {"size": os.path.getsize(ap),
                        "crc32": _file_crc32(ap)}
    tmp = os.path.join(path, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"version": 1, "files": entries}, f)
    os.replace(tmp, os.path.join(path, _MANIFEST))


def _payload_stat_sig(path):
    """Stat-only fingerprint of the payload files: a truncation or rewrite
    changes a size or mtime and forces the crc pass to run again."""
    sig = []
    for rel, ap in _iter_payload_files(path):
        try:
            st = os.stat(ap)
        except OSError:
            sig.append((rel, -1, -1))
            continue
        sig.append((rel, st.st_size, st.st_mtime_ns))
    return tuple(sig)


def _verify_manifest(path):
    """True when every manifested file exists with matching size and
    crc32.  A step dir without a manifest passes (the marker protocol is
    its only guarantee)."""
    mpath = os.path.join(path, _MANIFEST)
    try:
        mstat = os.stat(mpath)
    except OSError:
        return True
    sig = (mstat.st_mtime_ns, _payload_stat_sig(path))
    memo = _verify_memo.get(path)
    if memo is not None and memo[0] == sig:
        return memo[1]
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        ok = True
        for rel, want in manifest.get("files", {}).items():
            ap = os.path.join(path, rel)
            if not os.path.isfile(ap) \
                    or os.path.getsize(ap) != want["size"] \
                    or _file_crc32(ap) != want["crc32"]:
                ok = False
                break
    except (OSError, ValueError, KeyError):
        ok = False
    _verify_memo[path] = (sig, ok)
    return ok


def _step_path(directory, step):
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def _scan_steps(directory, verify=True):
    """One directory pass: sorted [(step, complete)]; with verify,
    complete means the marker and a verified manifest, without it the
    marker alone (the retention criterion)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = _STEP_DIR.match(d)
        if not m:
            continue
        path = os.path.join(directory, d)
        complete = os.path.exists(os.path.join(path, _MARKER)) \
            and (not verify or _verify_manifest(path))
        out.append((int(m.group(1)), complete))
    return sorted(out)


def latest_step(directory):
    """Highest complete (markered and checksum-verified) step in
    `directory`, or None; verifies newest first and stops at the first
    good one."""
    if not os.path.isdir(directory):
        return None
    marked = []
    for d in os.listdir(directory):
        m = _STEP_DIR.match(d)
        if m and os.path.exists(os.path.join(directory, d, _MARKER)):
            marked.append(int(m.group(1)))
    for s in sorted(marked, reverse=True):
        if _verify_manifest(_step_path(directory, s)):
            return s
    return None


def _current_topology():
    """The writer's shape: process count and index from the launcher's
    environment, the host, the local CUDA devices."""
    topo = {"process_count": int(os.environ.get("WORLD_SIZE", "1")),
            "process_index": int(os.environ.get("RANK", "0")),
            "host": socket.gethostname()}
    if torch.cuda.is_available():
        topo["local_device_count"] = torch.cuda.device_count()
    return topo


def _no_orbax(what):
    return NotImplementedError(
        f"{what}: orbax checkpoints are JAX-only and the port has no orbax "
        f"reader or writer; use writer='npz' (both packages read and write "
        f"it)")


def save_checkpoint(directory, state, step, sparse_tables=None,
                    extras=None, topology=None, writer=None):
    """Write `state` at `step` as `step_<step>/state/arrays.npz`, then the
    extras and sparse tables, `_TOPOLOGY.json`, the manifest and last the
    marker.  Returns the step's path.

    sparse_tables: {name: table} with `state_dict()` -> {"ids", "values"}.
    extras: {name: array} beside the state (read with `load_extras`).
    topology: a dict merged over the writer's shape in `_TOPOLOGY.json`.
    writer: None or "npz"; "orbax" raises."""
    t0 = time.perf_counter()
    if writer not in (None, "npz"):
        if writer == "orbax":
            raise _no_orbax("save_checkpoint(writer='orbax')")
        raise ValueError(f"unknown checkpoint writer {writer!r}")
    path = _step_path(directory, step)
    if os.path.isdir(path):  # overwrite an old or incomplete attempt
        shutil.rmtree(path)
        _verify_memo.pop(path, None)
    os.makedirs(os.path.join(path, "state"), exist_ok=True)
    arrays = {k: _leaf_array(v) for k, v in flatten_with_path(state)}
    tmp = os.path.join(path, "state", "arrays.npz.tmp")
    with open(tmp, "wb") as f:
        save_npz(f, arrays)
    os.replace(tmp, os.path.join(path, "state", "arrays.npz"))
    if sparse_tables:
        payload = {}
        for name, table in sparse_tables.items():
            st = table.state_dict()
            payload[f"{name}.ids"] = st["ids"]
            payload[f"{name}.values"] = st["values"]
        save_npz(os.path.join(path, "sparse_tables.npz"), payload)
    if extras:
        save_npz(os.path.join(path, "extras.npz"),
                 {k: _leaf_array(v) for k, v in extras.items()})
    topo = _current_topology()
    topo.update(topology or {})
    topo["step"] = step
    topo["wall_time"] = time.time()
    with open(os.path.join(path, _TOPOLOGY), "w") as f:
        json.dump(topo, f)
    # the crash window: the arrays are on disk, the marker is not; a kill
    # here leaves the previous checkpoint as the resume point
    _write_manifest(path)
    with open(os.path.join(path, _MARKER), "w") as f:
        f.write("ok\n")
    # the writer just computed these CRCs: seed the verification memo
    _verify_memo[path] = ((os.stat(os.path.join(path, _MANIFEST))
                           .st_mtime_ns, _payload_stat_sig(path)), True)
    save_checkpoint.last_seconds = time.perf_counter() - t0
    return path


save_checkpoint.last_seconds = None


def load_checkpoint(directory, template_state, step=None,
                    sparse_tables=None):
    """Restore a checkpoint into the structure of `template_state` (e.g. a
    fresh TrainState): every leaf from `arrays.npz`, on its template leaf's
    device.  Returns (state, step)."""
    t0 = time.perf_counter()
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _step_path(directory, step)
    npz = os.path.join(path, "state", "arrays.npz")
    if not os.path.isfile(npz):
        raise _no_orbax(f"load_checkpoint({path})")
    with np.load(npz) as data:
        state = _rebuild(template_state, "",
                         lambda key, tmpl: _restore_leaf(tmpl, data[key]))
    if sparse_tables:
        with np.load(os.path.join(path, "sparse_tables.npz")) as data:
            for name, table in sparse_tables.items():
                table.load_state_dict({"ids": data[f"{name}.ids"],
                                       "values": data[f"{name}.values"]})
    load_checkpoint.last_seconds = time.perf_counter() - t0
    return state, step


load_checkpoint.last_seconds = None


def load_extras(directory, step=None):
    """The extras sidecar of checkpoint `step` (default: the latest
    complete) as {name: np.ndarray}; {} when it has none."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    p = os.path.join(_step_path(directory, step), "extras.npz")
    if not os.path.isfile(p):
        return {}
    with np.load(p) as npz:
        return {k: npz[k] for k in npz.files}


def load_topology(directory, step=None):
    """The `_TOPOLOGY.json` of checkpoint `step` (default: the latest
    complete), or None for a checkpoint without one."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    p = os.path.join(_step_path(directory, step), _TOPOLOGY)
    if not os.path.isfile(p):
        return None
    with open(p) as f:
        return json.load(f)


def resharded_cursor(step, old_world=None, new_world=None,
                     preserve_global_batch=True):
    """The data cursor (consumed global batches) after restoring
    checkpoint `step` onto another world size: unchanged when the global
    batch is preserved, else ``step * old_world // new_world`` (floor: a
    partial new batch is consumed again, never skipped)."""
    step = int(step)
    if preserve_global_batch:
        return step
    if not old_world or not new_world:
        raise ValueError("per-rank-batch cursor scaling needs old_world "
                         "and new_world")
    return (step * int(old_world)) // int(new_world)


def restore_resharded(directory, template_state, mesh=None, step=None,
                      sparse_tables=None, state_specs=None):
    raise NotImplementedError(
        "restore_resharded (a restore onto another mesh) is not ported to "
        "paddle_tpu_torch yet (ROADMAP item 8, the distributed tier)")


class CheckpointManager:
    """Keep-last-N rolling checkpoints with save_interval gating."""

    def __init__(self, directory, max_to_keep=3, save_interval_steps=1,
                 writer=None):
        if writer not in (None, "npz"):
            if writer == "orbax":
                raise _no_orbax("CheckpointManager(writer='orbax')")
            raise ValueError(f"unknown checkpoint writer {writer!r}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.writer = writer

    def should_save(self, step):
        return step % self.save_interval_steps == 0

    def save(self, state, step, sparse_tables=None, force=False,
             extras=None, topology=None):
        """Checkpoint if `step` is on the save interval (or force=True).
        Returns the path, or None when gated off."""
        if not force and not self.should_save(step):
            return None
        path = save_checkpoint(self.directory, state, step, sparse_tables,
                               extras=extras, topology=topology,
                               writer=self.writer)
        self._gc()
        return path

    def load_extras(self, step=None):
        return load_extras(self.directory, step)

    def load_topology(self, step=None):
        return load_topology(self.directory, step)

    def latest_step(self):
        return latest_step(self.directory)

    def restore_latest(self, template_state, sparse_tables=None):
        return load_checkpoint(self.directory, template_state,
                               sparse_tables=sparse_tables)

    def restore_resharded(self, template_state, mesh=None, step=None,
                          sparse_tables=None, state_specs=None):
        return restore_resharded(self.directory, template_state, mesh=mesh,
                                 step=step, sparse_tables=sparse_tables,
                                 state_specs=state_specs)

    def _gc(self):
        """Rolling retention plus orphan cleanup: crashed attempts (no
        marker) older than the newest markered step go; one newer than it
        may be a save in flight and stays.  Retention trusts the marker
        alone; rotation never deletes the newest verified-good step."""
        scan = _scan_steps(self.directory, verify=False)
        complete = [s for s, ok in scan if ok]
        doomed = complete[:-self.max_to_keep]
        if doomed:
            newest_good = latest_step(self.directory)
            doomed = [s for s in doomed
                      if newest_good is not None and s < newest_good]
        if complete:
            newest = complete[-1]
            doomed += [s for s, ok in scan if not ok and s < newest]
        for s in doomed:
            path = _step_path(self.directory, s)
            shutil.rmtree(path, ignore_errors=True)
            _verify_memo.pop(path, None)
