"""Fault-tolerant checkpointing (port of ``repro/checkpoint/manager.py``):
atomic saves, keep-N GC, resume from the latest *valid* checkpoint (torn
writes are skipped), and elastic resharding on restore (the mesh may
change between runs).

Layout, the JAX package's:  <dir>/step_<k>.tmp/ -> (atomic rename) ->
<dir>/step_<k>/ holding ``arrays.npz`` (flat ``{path: array}``, paths the
``/``-joined dict keys) and ``manifest.json`` (step, keys, the
``committed`` marker).

Every leaf is written whole.  Under ``torch.distributed`` with
``shardings`` (a tree of :class:`repro_torch.core.sharding.NamedSharding`
like the state's), every rank gathers the full arrays from the TP and
ZeRO shards, rank 0 writes them, and every rank waits at a barrier; a
replicated state needs no ``shardings``.  :func:`restore` reads the full
arrays and, with ``shardings``, cuts this rank's blocks on the current
mesh, whatever mesh wrote them.

bfloat16 leaves are written as float32 (exact; numpy has no bfloat16
without ``ml_dtypes``) and cast back to the template's dtype on restore;
a JAX checkpoint's bfloat16 arrays (two raw bytes an element in the npz)
are read as bfloat16 bits.  A float32 checkpoint is the same file in
either package.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def _paths(tree, prefix=()):
    """(path key, leaf) pairs, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _to_tensor(a: np.ndarray, like) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:       # JAX bfloat16
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def _lead() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         extra_meta: Optional[Dict] = None, shardings=None) -> str:
    """Write ``tree`` (nested dicts of tensors) as step ``step``.  Every
    rank of an initialised world calls it; see the module docstring."""
    if shardings is not None:
        from repro_torch.core.sharding import gather
        tree = gather(tree, shardings)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if _lead():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f"step_{step:010d}.tmp")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = {k: _to_numpy(v) for k, v in _paths(tree)}
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "keys": sorted(flat),
                    "committed": True, **(extra_meta or {})}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic commit
        _gc(ckpt_dir, keep)
    if dist.is_initialized():
        dist.barrier()
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if _valid(os.path.join(ckpt_dir, name)):
                out.append(int(name[5:]))
    return sorted(out)


def _valid(path: str) -> bool:
    mf = os.path.join(path, "manifest.json")
    if not (os.path.exists(mf) and
            os.path.exists(os.path.join(path, "arrays.npz"))):
        return False
    try:
        with open(mf) as f:
            return bool(json.load(f).get("committed"))
    except (json.JSONDecodeError, OSError):
        return False


def restore(ckpt_dir: str, step: int, template, shardings=None) -> Any:
    """Restore into ``template``'s structure, each leaf in its template
    leaf's dtype and device; with ``shardings``, cut to this rank's block
    (elastic reshard: the full array is re-laid-out onto this mesh)."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    it = (k for k, _ in _paths(template))
    tree = tree_map(lambda like: _to_tensor(arrays[next(it)], like),
                    template)
    if shardings is not None:
        from repro_torch.core.sharding import device_put
        tree = device_put(tree, shardings)
    return tree


def restore_latest(ckpt_dir: str, template, shardings=None
                   ) -> Tuple[Optional[int], Any]:
    """(step, tree) from the newest valid checkpoint, or (None, template).

    Walks backwards over checkpoints so a torn/corrupt newest write (node
    failure mid-save) falls through to the previous one."""
    for step in reversed(list_steps(ckpt_dir)):
        try:
            return step, restore(ckpt_dir, step, template, shardings)
        except (KeyError, OSError, ValueError):
            continue
    return None, template
