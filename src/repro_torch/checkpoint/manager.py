"""Fault-tolerant checkpoint manager, on tensors.

  * atomic: a step is written into `step_<n>.tmp`, fsynced and renamed;
  * keep-k pruning of complete checkpoints;
  * async save on a background thread: the loop never waits for the disk.
    The host copies are made before `save` returns (CUDA tensors go into
    pinned buffers with non-blocking copies and one event, which the
    writer thread synchronises before it reads them), so the next chunk
    may start at once;
  * the on-disk format is the reference's byte for byte (`arrays.npz`
    keyed by the tree path, `#i` for a sequence index and ``\\x1f`` for
    ``/``, plus `meta.json`), so a snapshot written by either package
    restores in the other.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch


class FingerprintMismatch(ValueError):
    """A checkpoint directory holds snapshots written by a different run
    configuration (graph / program / knob fingerprint disagrees)."""


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten_into(template, flat, prefix=""):
    """Rebuild a tree with template's structure from the flat dict."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, list):
        return [_unflatten_into(v, flat, f"{prefix}#{i}/")
                for i, v in enumerate(template)]
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[
            _unflatten_into(getattr(template, k), flat, f"{prefix}{k}/")
            for k in template._fields])
    if isinstance(template, tuple):
        return tuple(_unflatten_into(v, flat, f"{prefix}#{i}/")
                     for i, v in enumerate(template))
    return flat[prefix.rstrip("/")]


def _host_copies(flat):
    """Host copies of the flat leaves, safe to read from another thread
    once the returned `ready()` has run: CPU tensors are cloned, CUDA
    tensors copied without blocking into pinned buffers behind one event
    per device."""
    host, events = {}, []
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.is_cuda:
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v, non_blocking=True)
                host[k] = buf
                continue
            host[k] = v.clone()
        else:
            host[k] = np.array(v)
    devices = {v.device for v in flat.values()
               if isinstance(v, torch.Tensor) and v.is_cuda}
    for d in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        events.append(ev)

    def ready():
        for ev in events:
            ev.synchronize()
        return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in host.items()}

    return ready


class CheckpointManager:
    def __init__(self, directory: str, keep: Optional[int] = 3,
                 async_save: bool = True):
        """`keep` retains the newest `keep` complete checkpoints after
        every save; `keep=None` or `keep <= 0` keeps everything."""
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None,
             block: bool = False):
        self.wait()  # one in-flight save at a time
        ready = _host_copies(_flatten(tree))
        meta = dict(metadata or {}, step=int(step), time=time.time())

        def _write():
            host = ready()
            tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
            final = os.path.join(self.dir, f"step_{step:010d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{k.replace("/", "\x1f"): v for k, v in host.items()})
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._prune()

        def _write_captured():
            # a thread's exception would vanish into threading.excepthook:
            # keep it, and the next wait()/save() raises it
            try:
                _write()
            except BaseException as e:
                self._error = e

        if self.async_save and not block:
            self._pending = threading.Thread(target=_write_captured,
                                             daemon=True)
            self._pending.start()
        else:
            _write()

    def wait(self):
        """Block until the in-flight async save (if any) is durable.
        Re-raises the exception of a failed background save."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint save into {self.dir} failed") from err

    def _prune(self):
        if not self.keep or self.keep <= 0:  # keep everything
            return
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- load ---------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None) -> Any:
        """Restore into template's structure: numpy leaves, or tensors on
        `device` when one is given."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}", "arrays.npz")
        with np.load(path) as z:  # npz loads lazily: materialize, close
            flat = {k.replace("\x1f", "/"): np.asarray(z[k])
                    for k in z.files}
        if device is not None:
            flat = {k: torch.from_numpy(v).to(device)
                    for k, v in flat.items()}
        return _unflatten_into(template, flat)

    def metadata(self, step: Optional[int] = None) -> dict:
        if step is None:
            step = self.latest_step()
        with open(os.path.join(self.dir, f"step_{step:010d}",
                               "meta.json")) as f:
            return json.load(f)


# ---------------------------------------------------------------------------
# Resume fingerprints (graph / program / knob identity of a checkpoint)
# ---------------------------------------------------------------------------

def array_signature(*arrays) -> str:
    """sha1 over the raw bytes (and dtypes/shapes) of host arrays."""
    h = hashlib.sha1()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def graph_signature(graph) -> str:
    """sha1 identity of a PropertyGraph-shaped object (duck-typed):
    vertex count, directedness, edge endpoints, and every named
    edge/vertex property in sorted order. The reference's hash for the
    same graph."""
    h = hashlib.sha1()
    h.update(f"V={int(graph.num_vertices)};".encode())
    h.update(f"directed={bool(getattr(graph, 'directed', True))};".encode())
    parts = [graph.src, graph.dst]
    for name in ("edge_props", "vertex_props"):
        props = getattr(graph, name, None) or {}
        for k in sorted(props):
            h.update(f"{name}/{k};".encode())
            parts.append(props[k])
    h.update(array_signature(*parts).encode())
    return h.hexdigest()


def program_signature(program) -> str:
    """Deterministic identity of a VCProgram instance: class path plus
    its (sorted) instance attributes' reprs."""
    attrs = getattr(program, "__dict__", {})
    body = ",".join(f"{k}={attrs[k]!r}" for k in sorted(attrs))
    cls = type(program)
    return f"{cls.__module__}.{cls.__qualname__}({body})"


def resume_step(manager: CheckpointManager, fingerprint: dict,
                resume: str = "auto") -> Optional[int]:
    """Pick the checkpoint step to resume from, or None for a fresh run.

    resume="auto"   resume from the latest snapshot if one exists;
    resume="never"  ignore existing snapshots (fresh run, may overwrite);
    resume="must"   require a snapshot — FileNotFoundError otherwise.

    A found snapshot's stored fingerprint must match `fingerprint`
    exactly; a mismatch raises FingerprintMismatch rather than resuming
    incompatible state."""
    if resume not in ("auto", "never", "must"):
        raise ValueError(f'resume must be "auto"|"never"|"must", '
                         f"got {resume!r}")
    if resume == "never":
        return None
    step = manager.latest_step()
    if step is None:
        if resume == "must":
            raise FileNotFoundError(
                f'resume="must" but no checkpoints in {manager.dir}')
        return None
    saved = manager.metadata(step).get("fingerprint", {})
    bad = {k: (saved.get(k), v) for k, v in fingerprint.items()
           if saved.get(k) != v}
    if bad:
        raise FingerprintMismatch(
            f"checkpoint at step {step} in {manager.dir} was written by a "
            f"different run configuration ({{key: (saved, current)}} = "
            f"{bad}); pass resume='never' or use a fresh checkpoint_dir")
    return step
