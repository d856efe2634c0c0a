"""Device meshes (port of ``repro/launch/mesh.py``): ``DeviceMesh``es over
the ranks of the process group, with JAX's axis names.  Functions only;
importing this module touches no device or process group."""
from __future__ import annotations

import torch
import torch.distributed as dist


def _device_type(device: str) -> str:
    """'cuda' (NCCL) unless the caller asks for 'cpu' (gloo); no fallback:
    a card is required unless ``device`` is 'cpu'."""
    if device == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for the CPU "
                           "mesh (gloo)")
    return "cuda"


def _mesh(device: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    kind = _device_type(device)
    if kind == "cuda" and dist.is_initialized():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16 x 16 ('data', 'model'): 256 ranks, or 2 x 16 x 16 ('pod',
    'data', 'model'): 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = dist.get_world_size() if dist.is_initialized() else 1
    want = 512 if multi_pod else 256
    if n != want:
        raise ValueError(f"the production mesh {shape} needs {want} ranks; "
                         f"the process group has {n}")
    return _mesh(device, shape, axes)


def make_host_mesh(device: str = "cuda"):
    """Every rank of the process group on 'data', 1 on 'model' (one rank
    a card on 'cuda', NCCL; one rank a process on 'cpu', gloo)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh(device, (n, 1), ("data", "model"))
