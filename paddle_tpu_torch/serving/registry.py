"""Versioned model registry + AOT cold-start cache (port of
paddle_tpu/serving/registry.py).

The fleet's shared store of deployable model artifacts.  Every replica
loads from here; the router rolls versions forward and back by flipping
one pointer.  Crash safety reuses the file-based coordination idiom of
checkpoint.py (its manifest, marker and verifier):

- a version directory under ``versions/v<NNNN>/`` holds a COPY of one
  ``save_inference_model`` output (``__model__.json`` +
  ``__params__.npz``, plus ``__compiled__.pt2`` when present);
- a per-file checksum ``_MANIFEST.json`` (size + crc32) is written
  after the payload, and the ``_COMPLETE`` marker LAST — so a reader
  that lists versions concurrently with a publish (or after a
  publisher was SIGKILL'd mid-copy) can never see a partial artifact:
  no marker, or a manifest mismatch, means the version does not exist;
- the ``CURRENT`` pointer is a one-line file flipped via tmp +
  ``os.replace`` — readers see the old version or the new one,
  atomically, never a torn write.  Rollback is the same flip pointed
  backwards: version payloads are immutable, so re-flipping to vN
  restores bitwise-identical predictions.

The AOT cache (``aot/v<NNNN>/<device_kind>/``) holds per-bucket
``torch.export`` artifacts (``b<bucket>.pt2``) written by the FIRST
replica to warm a version (BucketDispatcher.export_aot), under the same
manifest+marker protocol.  A cold replica imports them (import_aot) and
reaches first byte with ZERO ``serving.bucket_compile`` events — the
cache key is (program version, device kind), where the device kind is
the sanitized ``torch.cuda.get_device_name()`` or ``cpu``, so an
artifact can never be replayed onto the wrong program or the wrong
card.

Fault injection: ``publish``/``publish_aot`` visit
``registry.before_marker`` / ``registry.aot.before_marker`` crash
points between the payload write and the marker, so the
kill-during-publish reader race is testable on purpose.
"""

import os
import re
import shutil

from ..checkpoint import (_MANIFEST, _MARKER, _verify_manifest,
                          _write_manifest)

__all__ = ["ModelRegistry", "RegistryError"]

_VERSION_DIR = re.compile(r"^v(\d{4,})$")
_CURRENT = "CURRENT"
_KIND_RE = re.compile(r"[^a-zA-Z0-9_.-]+")


class RegistryError(RuntimeError):
    """A registry operation referenced a version that does not exist
    (or is incomplete — which, under the marker protocol, is the same
    thing)."""


def _crash_point(name):
    from ..resilience import faultinject

    faultinject.crash_point(name)


def _sanitize_kind(device_kind):
    """Device-kind strings name directories ("NVIDIA H100 80GB HBM3"
    carries spaces); collapse anything unsafe to '_'."""
    return _KIND_RE.sub("_", str(device_kind)) or "unknown"


class ModelRegistry:
    """Shared-store registry of versioned inference-model artifacts.

    reg = ModelRegistry(root)
    v1 = reg.publish(model_dir)        # atomic: manifest, marker LAST
    reg.set_current(v1)                # atomic pointer flip
    Predictor(reg.version_dir(reg.current()))
    """

    def __init__(self, root):
        self.root = os.path.abspath(root)
        self.versions_root = os.path.join(self.root, "versions")
        self.aot_root = os.path.join(self.root, "aot")
        os.makedirs(self.versions_root, exist_ok=True)

    # -- versions -------------------------------------------------------
    def version_dir(self, version):
        return os.path.join(self.versions_root, "v%04d" % int(version))

    def _is_complete(self, path):
        return os.path.exists(os.path.join(path, _MARKER)) \
            and _verify_manifest(path)

    def versions(self):
        """Sorted COMPLETE versions — a publish in flight (or killed
        mid-copy) is invisible until its marker lands."""
        out = []
        for d in os.listdir(self.versions_root):
            m = _VERSION_DIR.match(d)
            if not m:
                continue
            if self._is_complete(os.path.join(self.versions_root, d)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self):
        vs = self.versions()
        return vs[-1] if vs else None

    def publish(self, model_dir, version=None):
        """Copy one save_inference_model output into the store as the
        next (or an explicit) version.  Payload first, manifest second,
        marker LAST — a concurrent reader sees all of it or none of it.
        Returns the version number."""
        if version is None:
            taken = [int(m.group(1)) for d in os.listdir(self.versions_root)
                     for m in (_VERSION_DIR.match(d),) if m]
            version = (max(taken) + 1) if taken else 1
        vdir = self.version_dir(version)
        if os.path.exists(os.path.join(vdir, _MARKER)):
            raise RegistryError(f"version {version} already published")
        os.makedirs(vdir, exist_ok=True)
        for f in sorted(os.listdir(model_dir)):
            src = os.path.join(model_dir, f)
            if not os.path.isfile(src) or f in (_MARKER, _MANIFEST):
                continue
            shutil.copy2(src, os.path.join(vdir, f))
        _write_manifest(vdir)
        _crash_point("registry.before_marker")
        with open(os.path.join(vdir, _MARKER), "w") as f:
            f.write("ok\n")
        return int(version)

    # -- the CURRENT pointer --------------------------------------------
    def set_current(self, version):
        """Atomically flip the fleet-wide CURRENT pointer (tmp +
        os.replace).  Only a COMPLETE version may become current —
        flipping to a half-published artifact is exactly the race the
        marker protocol exists to kill."""
        version = int(version)
        if not self._is_complete(self.version_dir(version)):
            raise RegistryError(
                f"version {version} is not a complete published artifact")
        tmp = os.path.join(self.root, _CURRENT + ".tmp.%d" % os.getpid())
        with open(tmp, "w") as f:
            f.write("%d\n" % version)
        os.replace(tmp, os.path.join(self.root, _CURRENT))

    def current(self):
        """The pointed-at version, or None.  A pointer at a version
        that has stopped verifying (bit rot after publish) is treated
        as absent rather than served."""
        try:
            with open(os.path.join(self.root, _CURRENT)) as f:
                v = int(f.read().strip())
        except (OSError, ValueError):
            return None
        return v if self._is_complete(self.version_dir(v)) else None

    def current_dir(self):
        v = self.current()
        return self.version_dir(v) if v is not None else None

    # -- AOT artifact cache ---------------------------------------------
    def aot_dir(self, version, device_kind):
        return os.path.join(self.aot_root, "v%04d" % int(version),
                            _sanitize_kind(device_kind))

    def has_aot(self, version, device_kind):
        return self._is_complete(self.aot_dir(version, device_kind))

    def publish_aot(self, version, device_kind, writer):
        """Populate the (version, device kind) AOT cache cell under the
        manifest+marker protocol.  ``writer(dirname)`` stages the
        artifact files (BucketDispatcher.export_aot is the canonical
        writer) and returns how many it wrote; nothing is marked
        complete unless it wrote at least one.  Idempotent: an already-
        complete cell is left untouched (first publisher wins — the
        artifacts are deterministic per (program version, device))."""
        adir = self.aot_dir(version, device_kind)
        if self._is_complete(adir):
            return 0
        os.makedirs(adir, exist_ok=True)
        n = writer(adir)
        if not n:
            return 0
        _write_manifest(adir)
        _crash_point("registry.aot.before_marker")
        with open(os.path.join(adir, _MARKER), "w") as f:
            f.write("ok\n")
        return n
