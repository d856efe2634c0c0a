"""Atomic checkpointing (port of ``repro/checkpoint/manager.py``), in the
JAX package's on-disk layout.

Layout:  <dir>/step_<n>/ {manifest.json, leaf_<i>.npy ...}, one file per
leaf, numbered in JAX's leaf order (dict keys sorted), keyed in the
manifest by JAX's key string (``['params']['embed']['table']``) with the
leaf's shape, dtype and a sha256 prefix of its bytes.  Writes go to a
``.tmp`` directory first and are renamed into place only after the
manifest is fsynced, so a crash mid-save never shadows the previous valid
checkpoint; ``restore_latest`` takes the newest directory whose manifest
validates.  numpy cannot save bfloat16, so a bf16 leaf is stored as its
uint16 bits with ``"bfloat16"`` in the manifest (the bytes, and so the
sha, are the bf16 tensor's own).

A sharded state (DTensor leaves) is saved as its full logical arrays,
gathered leaf by leaf and written by rank 0 alone, in the same layout (JAX
gathers at save too); every rank takes part in the gathers and returns
once the directory is in place.  ``restore(..., device=)`` places every
leaf on one device; ``restore(..., shardings=)`` (elastic placement) reads
the whole arrays on every rank and places each leaf by its
``MeshSharding`` from the rank's own block, so a checkpoint written on one
mesh restores onto any other, or onto one device.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.sharding import place


def _paths(tree, path=""):
    """[(JAX key string, leaf)] in JAX's flatten order (dict keys sorted;
    None is an empty subtree)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _paths(v, f"{path}[{i}]")]
    if tree is None:
        return []
    return [(path, tree)]


def _map_paths(tree, fn, path=""):
    """``tree`` with each leaf replaced by fn(key string, leaf)."""
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_paths(v, fn, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _to_numpy(leaf):
    """-> (array to store, manifest dtype name)."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def save(ckpt_dir: str, step: int, state, keep: int = 3) -> str:
    """Blocking atomic save of a tree of tensors (or DTensors: every rank
    calls it, rank 0 writes)."""
    sharded = any(isinstance(t, DTensor) for _, t in _paths(state))
    writer = not sharded or dist.get_rank() == 0
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    manifest = {"step": int(step), "leaves": []}
    for i, (key, leaf) in enumerate(_paths(state)):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if not writer:
            continue
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "key": key, "file": fname, "shape": list(arr.shape),
            "dtype": dtype, "sha": _digest(arr)})
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)
    if sharded:
        dist.barrier()
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def _validate(path: str) -> bool:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return False
    try:
        with open(mf) as f:
            manifest = json.load(f)
        return all(os.path.exists(os.path.join(path, rec["file"]))
                   for rec in manifest["leaves"])
    except (json.JSONDecodeError, KeyError):
        return False


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d[5:]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and _validate(os.path.join(ckpt_dir, d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, device=None,
            verify: bool = False, shardings=None):
    """Restore into the structure of ``like`` (a tree of tensors, ``meta``
    tensors or anything with ``.shape``), each leaf on ``device``
    (default: the ``like`` leaf's device when it is a real tensor, else the
    CPU), or with ``shardings`` (a tree of ``MeshSharding`` parallel to
    ``like``) as DTensors placed from each rank's own block."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {rec["key"]: rec for rec in manifest["leaves"]}

    def load(key, leaf):
        rec = by_key[key]
        arr = np.load(os.path.join(path, rec["file"]))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: stored {arr.shape}, expected "
                             f"{tuple(leaf.shape)}")
        if verify and _digest(arr) != rec["sha"]:
            raise ValueError(f"checksum mismatch: {key}")
        t = torch.from_numpy(arr)
        if rec["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        if shardings is not None:
            return place(t, by_sharding[key], device)
        where = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor)
            and leaf.device.type != "meta" else "cpu")
        return t.to(where)

    by_sharding = dict(_paths(shardings)) if shardings is not None else {}
    return _map_paths(like, load)


def restore_latest(ckpt_dir: str, like, device=None, shardings=None):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return restore(ckpt_dir, step, like, device,
                   shardings=shardings), step
