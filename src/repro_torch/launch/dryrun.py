"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): run every (arch x
shape x mesh) cell once on fake tensors and record what it asks of a card.

The process joins a fake process group of 256 or 512 ranks (every
collective returns at once, nothing is sent) as rank 0 and builds the
production mesh on it (a CPU ``DeviceMesh``: the dry run needs no card and
runs the same on any host).  Each cell's arguments are placed as DTensors
over fake tensors (shapes, no storage), and the cell's ``fn``, the port's
own train step, prefill or decode step, runs on them under
``launch.hlo_cost``'s counter and ``MemTracker``: K1-K4 give outputs of the
right shapes and count by their work formulas.  Each record holds rank 0's
peak live bytes (``memory.peak_per_device``, and ``fits`` on an 80 GB
card), FLOPs by dtype, bytes and collectives per device, and PyTorch's own
``FlopCounterMode`` total for reference, as JAX's kept XLA's (over
DTensors it counts the global op).  The first run of a cell only warms
DTensor's sharding propagation (see ``hlo_cost``); the second is recorded.
A failure here (a sharding rule DTensor lacks, a cell that does not fit)
is a fault of the port, not of the harness.

A fake process group is global to its process, so the dry run runs in a
process of its own.  JAX's ``--save-hlo`` has no counterpart: there is no
HLO.  ``--world N`` runs a small mesh of N ranks, (N/2, 2) ('data',
'model') or (1, 1), where JAX sets ``REPRO_DRYRUN_DEVICES``.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes --out r.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.launch import hlo_cost, roofline
from repro_torch.launch.specs import build_cell
from repro_torch.models.params import tree_map


def init_fake_group(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (leaving a
    fake group of another size first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), world_size=world,
                            rank=0)


def small_mesh(world: int, multi_pod: bool = False):
    """A CPU mesh of ``world`` ranks: ('data', 'model') (world/2, 2), or
    (1, 1) for one rank; ``multi_pod`` puts a 'pod' axis of 2 first."""
    from torch.distributed.device_mesh import init_device_mesh
    n = world // 2 if multi_pod else world
    model = 2 if n % 2 == 0 else 1
    shape, names = (n // model, model), ("data", "model")
    if multi_pod:
        shape, names = (2,) + shape, ("pod",) + names
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.mesh.shape)


@contextlib.contextmanager
def card_alltoall():
    """Within the block DTensor moves a split from one dim to another with
    its all-to-all operator, as it does on a CUDA mesh (NCCL), and not with
    the all-gather and chunk it falls back to on a CPU mesh (gloo has no
    all-to-all): the dry run's mesh is a CPU mesh, its collectives the
    card's.  Where the installed DTensor has no such fallback function of
    this signature, or no such operator, nothing changes."""
    import inspect
    from torch.distributed.tensor import placement_types as pt
    orig = getattr(pt, "shard_dim_alltoall", None)
    try:
        op = torch.ops._dtensor.shard_dim_alltoall
        same = list(inspect.signature(orig).parameters) == [
            "input", "gather_dim", "shard_dim", "mesh", "mesh_dim"]
    except (AttributeError, TypeError, ValueError):
        same = False
    if not same:
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return op(input, gather_dim, shard_dim,
                  mesh.get_group(mesh_dim).group_name)
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


def place_args(cell, fake_mode):
    """The cell's abstract arguments as DTensors over fake tensors, each
    placed as its sharding says (rank 0's block of every split dim)."""
    from torch.distributed.tensor import DTensor

    def one(t, sh):
        shape = list(t.shape)
        for i, p in enumerate(sh.placements):
            if p.is_shard():
                shape[p.dim] //= sh.mesh.size(i)
        with fake_mode:
            local = torch.empty(shape, dtype=t.dtype, device="cpu")
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False)
    return tuple(tree_map(one, a, s)
                 for a, s in zip(cell.args, cell.in_shardings))


def run_cell(arch: str, shape_name: str, multi_pod: bool, mesh=None,
             verbose: bool = True, rules_version: str = "v1",
             shape=None, cfg=None, **cell_kw) -> dict:
    """One cell's record.  ``shape``/``cfg`` replace the named ones (a
    cut of them); ``cell_kw`` go to ``build_cell`` (``opt_cfg=``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    cfg = cfg or configs.get(arch)
    shape = shape or configs.SHAPES[shape_name]
    ok, reason = configs.cell_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "rules": rules_version,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    if mesh is None:
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rec.update(mesh=mesh_name(mesh), n_devices=mesh.size())
    t0 = time.time()
    try:
        cell = build_cell(cfg, shape, mesh, rules_version=rules_version,
                          **cell_kw)
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        args = place_args(cell, fake)
        with fake, card_alltoall():
            cell.fn(*args)                 # warms sharding propagation
            t_warm = time.time() - t0
            mt = MemTracker()
            mt.track_external(*(t.to_local() for t in _leaves(args)))
            with mt, FlopCounterMode(display=False) as fc, \
                    hlo_cost.Counter() as counter:
                cell.fn(*args)
        del args
        cost = counter.cost
        peak = max((s["Total"] for s in
                    mt.get_tracker_snapshot("peak").values()), default=0)
        rl = roofline.from_record(
            {"mesh": rec["mesh"], "n_devices": mesh.size(),
             "hlo_cost": cost.as_dict()}, cfg, shape)
        rec.update(
            status="ok", trace_s=round(time.time() - t0, 1),
            warm_s=round(t_warm, 1), tf32=counter.tf32,
            memory={"peak_per_device": int(peak)},
            fits=bool(peak <= roofline.HBM_BYTES),
            torch_flop_counter={"flops": float(fc.get_total_flops())},
            hlo_cost=cost.as_dict(),
            roofline={"compute_s": rl.compute_s, "memory_s": rl.memory_s,
                      "collective_s": rl.collective_s,
                      "bound_s": rl.bound_s, "dominant": rl.dominant,
                      "model_flops": rl.model_flops,
                      "useful_ratio": rl.useful_ratio})
        if verbose:
            print(f"[{arch}:{shape_name}:{rec['mesh']}] OK "
                  f"trace={rec['trace_s']}s "
                  f"peak/dev={peak / 2**30:.2f}GiB fits={rec['fits']} "
                  f"flops/dev={cost.flops:.3e} "
                  f"coll_bytes/dev={cost.collective_bytes:.3e} "
                  f"bound={rl.bound_s:.3e}s ({rl.dominant}, predicted)",
                  flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the matrix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[{arch}:{shape_name}:{rec['mesh']}] FAILED: "
                  f"{type(e).__name__}: {e}", flush=True)
    return rec


def _leaves(args):
    from repro_torch.models.params import leaves
    return [t for a in args for t in leaves(a)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--rules", default="v1", choices=["v1", "v2"])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks of a small mesh in place of the production "
                         "mesh's 256 (512 with --multi-pod)")
    args = ap.parse_args()

    cells = []
    if args.all:
        for arch in configs.ARCH_NAMES:
            for shape in configs.SHAPES:
                cells.append((arch, shape))
    else:
        cells.append((args.arch, args.shape))
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    out_f = open(args.out, "a") if args.out else contextlib.nullcontext()
    n_ok = n_skip = n_err = 0
    with out_f:
        for multi_pod in meshes:
            if args.world is not None:
                init_fake_group(args.world)
                mesh = small_mesh(args.world, multi_pod)
            else:
                from repro_torch.launch.mesh import make_production_mesh
                init_fake_group(512 if multi_pod else 256)
                mesh = make_production_mesh(multi_pod=multi_pod,
                                            device="cpu")
            for arch, shape in cells:
                rec = run_cell(arch, shape, multi_pod, mesh=mesh,
                               rules_version=args.rules)
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                n_err += rec["status"] == "error"
                if args.out:
                    out_f.write(json.dumps(rec) + "\n")
                    out_f.flush()
                gc.collect()
    print(f"dry-run done: {n_ok} ok, {n_skip} skipped (per assignment), "
          f"{n_err} errors", flush=True)
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
