"""Checkpointing: atomic, keep-k, async (port of
``repro.train.checkpoint``, in its file format).

Layout:  <dir>/step_<N>/arrays.npz + manifest.json
         <dir>/.step_<N>.tmp.<pid>/ ... -> os.replace() on completion

- Atomic: writes land in a tmp dir; a single ``os.replace`` publishes the
  step, so a crash mid-save never corrupts the latest checkpoint.
- Keep-k: older steps are pruned after a successful publish.
- Async: ``save_async`` copies the state to host memory at once and
  writes on a worker thread, overlapping the next train steps.
- Keys are the reference's paths of the state in its stacked layout:
  ``(params, opt)`` gives ``0/embed/embedding``, ``0/layers/attn/wq``,
  ``1/m/layers/...``, ``1/v/...`` and ``1/step``. A module (a family's
  parameters, or the optimizer's moments) is written as its ``.tree()``;
  dicts list their keys in sorted order, as ``jax.tree_util`` does. npz
  has no bfloat16: bf16 arrays are stored as their uint16 bits and listed
  in the manifest's ``bf16_keys``. The reference reads what this writes,
  and this reads what it writes.
- ``restore`` copies the arrays into the template's own tensors, or, given
  a ``device``, builds the state anew there.
- Preemption: ``PreemptionGuard`` installs a SIGTERM hook that saves.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn


def _items(node):
    """A node's children as (key, child): a module by its stacked tree, a
    named tuple by field, a tuple or list by index, a dict by sorted key;
    None for a leaf."""
    if isinstance(node, nn.Module):
        node = node.tree()
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, child in items:
        out.update(_flatten(child, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _to_numpy(t) -> np.ndarray:
    """A tensor on the host as numpy; bf16 as its uint16 bits."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_disk(a: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(np.asarray(a, order="C").view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, order="C"))


def _snapshot(state) -> Dict[str, tuple]:
    """key -> (numpy array on the host, whether it holds bf16 bits)."""
    return {k: (_to_numpy(v), torch.as_tensor(v).dtype == torch.bfloat16)
            for k, v in _flatten(state).items()}


class CheckpointManager:
    def __init__(self, directory: Union[str, os.PathLike], keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------- writing
    def save(self, step: int, state, extra: Optional[Dict] = None) -> Path:
        """Synchronous atomic save."""
        return self._write(step, _snapshot(state), extra or {})

    def save_async(self, step: int, state, extra: Optional[Dict] = None):
        """Snapshot to host memory now, write on a worker thread."""
        self.wait()  # one in-flight save at a time
        host = _snapshot(state)

        def work():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:  # noqa: BLE001 (raised in wait())
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _write(self, step: int, host: Dict[str, tuple], extra: Dict) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".step_{step:08d}.tmp.{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in host.items()})
        manifest = {"step": step, "time": time.time(), "keys": sorted(host),
                    "bf16_keys": [k for k, (_, bf) in host.items() if bf],
                    "extra": extra}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
        self._prune()
        return final

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ----------------------------------------------------------- reading
    def all_steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if p.is_dir())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_template, step: Optional[int] = None,
                device: Optional[Union[str, torch.device]] = None):
        """Restore into the template's structure: (state, step), each array
        in its template leaf's dtype. Without a ``device`` every array is
        copied into the template's own tensor and the template is
        returned; with one, the state is built anew on ``device`` (a module
        as ``type(m)(m.cfg, tree)``) and the template is left as it was."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        bf16 = set(self.manifest(step).get("bf16_keys", []))
        with np.load(self.dir / f"step_{step:08d}" / "arrays.npz") as raw:
            data = {k: _from_disk(raw[k], k in bf16) for k in raw.files}
        dev = torch.device(device) if device is not None else None
        return _rebuild(state_template, data, "", dev), step

    def manifest(self, step: int) -> Dict:
        return json.loads(
            (self.dir / f"step_{step:08d}" / "manifest.json").read_text())


def _leaf(tmpl, arr: torch.Tensor, key: str, device) -> torch.Tensor:
    """The saved array in the template leaf's dtype (as the reference's
    ``asarray(arr, dtype=tmpl.dtype)``), on ``device`` or the leaf's."""
    tmpl = torch.as_tensor(tmpl)
    if tuple(arr.shape) != tuple(tmpl.shape):
        raise ValueError(f"checkpoint leaf {key} has shape "
                         f"{tuple(arr.shape)}, the template's "
                         f"{tuple(tmpl.shape)}")
    return arr.to(device=device if device is not None else tmpl.device,
                  dtype=tmpl.dtype)


@torch.no_grad()
def _rebuild(node, data: Dict[str, torch.Tensor], prefix: str, device):
    if isinstance(node, nn.Module):
        # the family's module unstacks the restored tree as it was built
        fresh = type(node)(node.cfg, _rebuild(node.tree(), data, prefix,
                                              device or node.device))
        if device is not None:
            return fresh
        got = dict(fresh.named_parameters())
        for name, p in node.named_parameters():
            p.copy_(got[name])
        return node
    items = _items(node)
    if items is None:
        got = _leaf(node, data[prefix], prefix, device)
        if device is None and isinstance(node, torch.Tensor):
            node.copy_(got)
            return node
        return got
    kids = [_rebuild(c, data, f"{prefix}/{k}" if prefix else str(k), device)
            for k, c in items]
    if isinstance(node, dict):
        return dict(zip([k for k, _ in items], kids))
    if hasattr(node, "_fields"):
        return type(node)(*kids)
    return type(node)(kids)


class PreemptionGuard:
    """SIGTERM -> save (cloud eviction). Use as a context manager."""

    def __init__(self, save_fn: Callable[[], None]):
        self.save_fn = save_fn
        self.fired = False
        self._prev = None

    def __enter__(self):
        def handler(signum, frame):
            self.fired = True
            self.save_fn()
        self._prev = signal.signal(signal.SIGTERM, handler)
        return self

    def __exit__(self, *exc):
        signal.signal(signal.SIGTERM, self._prev)
        return False
