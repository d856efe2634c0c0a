"""Elastic re-sharding: shrink or regrow the mesh after failures (port of
``repro/ft/elastic.py``).

The policy layer: given the surviving rank count, pick the largest valid
(data, model) mesh that keeps the model axis if it can (the TP degree is a
property of the checkpointed layout's divisibility; the DP degree is
free), then restore the latest checkpoint with the new mesh's shardings.
Checkpoints hold full logical arrays (``checkpoint.manager``), so a
restore onto any mesh is each rank placing its own blocks.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch import checkpoint


def plan_mesh(n_devices: int, model_degree: int,
              pod_size: Optional[int] = None) -> Tuple[int, ...]:
    """Largest usable (pod?, data, model) shape for n surviving devices.

    TP degree is a memory-fit requirement of the checkpointed layout, so
    it is kept whenever at least one full model replica fits; devices past
    the largest data multiple idle (cheaper than an all-layout reshard).
    Only when fewer than ``model_degree`` devices survive does TP degrade
    by powers of two.
    """
    if n_devices <= 0:
        raise ValueError(
            f"plan_mesh: n_devices must be >= 1, got {n_devices} — a fleet "
            f"with no survivors has no mesh; stop serving instead")
    if model_degree <= 0:
        raise ValueError(
            f"plan_mesh: model_degree must be >= 1, got {model_degree}")
    model = model_degree
    while model > 1 and n_devices < model:
        model //= 2
    data = n_devices // model
    if pod_size and data * model > pod_size and (data * model) % pod_size == 0:
        return (data * model // pod_size, pod_size // model, model)
    return (data, model)


def make_mesh(devices: List[int], shape: Tuple[int, ...],
              device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the first prod(shape) of
    ``devices`` (global ranks, row-major), axes ('data', 'model') or
    ('pod', 'data', 'model'); every rank of the process group calls it."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.mesh import _device_type
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    n = 1
    for s in shape:
        n *= s
    ranks = torch.tensor(list(devices[:n]), dtype=torch.int64).reshape(shape)
    return DeviceMesh(_device_type(device), ranks, mesh_dim_names=axes)


def resume_on(mesh, ckpt_dir: str, abstract_state, sharding_fn):
    """Restore the latest checkpoint onto ``mesh``.

    ``sharding_fn(mesh) -> tree of MeshSharding`` matching the state.
    Returns (state, step) or (None, None) when no valid checkpoint exists.
    """
    shardings = sharding_fn(mesh)
    return checkpoint.restore_latest(ckpt_dir, abstract_state,
                                     shardings=shardings)
