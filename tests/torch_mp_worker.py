"""Jobs the multi-process tests of the PyTorch port run, one process a
rank, over gloo on the CPU.

The parent (a test) calls ``run(job, world, workdir)``: it starts
``world`` children of this file, which meet through a ``FileStore`` under
``workdir``, each with one thread and a process group whose collectives
time out after 90 s, and waits for them under a timeout of its own.
Children import ``torch`` and ``repro_torch`` only; the JAX package's
reference values reach them as files in ``workdir`` (``.npz``, or a
checkpoint in its on-disk layout), and rank 0 writes what it measured to
``workdir/result.json`` or ``result.npz``.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run(job: str, world: int, workdir, timeout: float = 240.0) -> None:
    """Run ``job`` on ``world`` ranks; raise with each failing rank's
    stderr tail if any rank fails or the run outlasts ``timeout``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(rank), str(world),
         str(workdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode, err[-3000:]) for r, (p, (_, err))
           in enumerate(zip(procs, outs)) if p.returncode != 0]
    assert not bad, "\n".join(f"rank {r} rc {rc}:\n{e}" for r, rc, e in bad)


# ---------------------------------------------------------------------------
# jobs (children)
# ---------------------------------------------------------------------------
def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


def _rel(a, b) -> float:
    """max |a - b| over max |b| (the rule of test_torch_lm.py)."""
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / scale if scale else \
        float((a - b).abs().max()) if a.numel() else 0.0


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _placed_as_resolved(state, shardings):
    """(every leaf's placements are its sharding's, every local shape is
    the resolved block's)."""
    from repro_torch.models.params import leaves
    ok_pl = ok_shape = True
    for t, sh in zip(leaves(state), leaves(shardings)):
        ok_pl &= tuple(t.placements) == sh.placements
        want = list(t.shape)
        for i, p in enumerate(sh.placements):
            if p.is_shard():
                want[p.dim] //= sh.mesh.size(i)
        ok_shape &= list(t.to_local().shape) == want
    return ok_pl, ok_shape


def job_train(rank, world, wd):
    """The sharded step on a (2, 2) data x model mesh under TRAIN_RULES
    against the unsharded step, for every arch in ``archs.json`` (an
    ``<arch>:accum<n>`` entry at ``accum_steps=n``, an
    ``<arch>+<heads>x<kv_heads>`` entry with those head counts, an
    ``<arch>@<d>x<m>`` entry on a (d, m) mesh, an ``<arch>!ef`` entry with
    int8 error feedback, ``use_ef=True``); a state from ``jax_<arch>`` (a
    JAX-written checkpoint) where there is one."""
    import numpy as np
    import torch
    from repro_torch import checkpoint, configs
    from repro_torch import train as T
    from repro_torch.launch.shardctx import ShardCtx
    from repro_torch.models.params import leaves
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.sharding import TRAIN_RULES, logical_sharding, place

    meshes = {}
    opt = AdamWConfig(weight_decay=0.01)
    out = {}
    for arch in json.loads((wd / "archs.json").read_text()):
        try:
            arch_, _, shape = arch.partition("@")
            shape = tuple(int(d) for d in (shape or "2x2").split("x"))
            if shape not in meshes:
                meshes[shape] = _mesh(shape, ("data", "model"))
            mesh = meshes[shape]
            sc = ShardCtx(mesh, TRAIN_RULES)
            name, _, accum = arch_.partition(":accum")
            name, _, heads = name.partition("+")
            name, ef, _ = name.partition("!ef")
            ef = bool(ef)
            cfg = configs.get(name, reduced=True)
            if accum:     # microbatches split from the placed batch
                cfg = dataclasses.replace(cfg, accum_steps=int(accum))
            if heads:
                h, kv = (int(n) for n in heads.split("x"))
                cfg = dataclasses.replace(cfg, n_heads=h, n_kv_heads=kv)
            astate = T.abstract_state(cfg, opt, use_ef=ef)
            sh = sc.tree(astate, T.state_logical(cfg, opt, use_ef=ef))
            ck = wd / f"jax_{arch}"
            if ck.exists():
                plain = checkpoint.restore(str(ck), 0, astate, "cpu")
                sharded = checkpoint.restore(str(ck), 0, astate,
                                             shardings=sh)
            else:
                plain = T.make_state(cfg, opt,
                                     torch.Generator().manual_seed(0), "cpu",
                                     use_ef=ef)
                sharded = T.make_state(
                    cfg, opt, torch.Generator().manual_seed(0), "cpu",
                    use_ef=ef, shardings=sh)
            arrays = np.load(wd / f"batch_{arch}.npz")
            batch = {k: torch.as_tensor(arrays[k]) for k in arrays.files}
            dbatch = {k: place(v, logical_sharding(
                v.shape, ("batch",) + (None,) * (v.ndim - 1), TRAIN_RULES,
                mesh)) for k, v in batch.items()}
            _, _, g_s = T.loss_and_grads(cfg, sharded["params"], dbatch, sc)
            _, _, g_p = T.loss_and_grads(cfg, plain["params"], batch)
            grad_rel = max(_rel(_full(a), b)
                           for a, b in zip(leaves(g_s), leaves(g_p)))
            if ef:
                ef_cmp = _ef_compared(g_s, g_p, sharded["ef"], plain["ef"])
            lr = constant(1e-3)
            sharded, m_s = T.make_train_step(cfg, opt, lr, sc=sc,
                                             use_ef=ef)(sharded, dbatch)
            plain, m_p = T.make_train_step(cfg, opt, lr,
                                           use_ef=ef)(plain, batch)
            param_rel = max(_rel(_full(a), b) for a, b in zip(
                leaves(sharded["params"]), leaves(plain["params"])))
            ok_pl, ok_shape = _placed_as_resolved(sharded, sh)
            out[arch] = {"loss_sharded": float(m_s["loss"]),
                         "loss_plain": float(m_p["loss"]),
                         "grad_rel": grad_rel, "param_rel": param_rel,
                         "placements": bool(ok_pl),
                         "local_shapes": bool(ok_shape)}
            if ef:
                ef_cmp["step_carries"] = all(torch.equal(
                    _full(a), _full(b)) for a, b in zip(
                        leaves(sharded["ef"]), leaves(ef_cmp.pop("ef"))))
                out[arch].update(ef_cmp, grad_norm=[float(m_s["grad_norm"]),
                                                    float(m_p["grad_norm"])])
        except NotImplementedError as e:
            out[arch] = {"error": f"NotImplementedError: {e}"}
    if rank == 0:
        (wd / "result.json").write_text(json.dumps(out))


def _ef_compared(g_s, g_p, ef_s, ef_p):
    """``ef_compress`` of the sharded and the unsharded gradients from the
    same residuals.  Both quantize g + e to int8 codes against its row's
    absmax; the gradients differ by f32 noise, so a code whose value sits
    that close to a rounding boundary may round the other way, moving the
    applied gradient one quantum (absmax / 127) and the new residual one
    quantum back, while their sum g + e does not move.  Returns the scales'
    and the sums' largest relative differences, the largest code
    difference in quanta, the largest share of codes that differ, and the
    sharded residuals (``ef``)."""
    import torch
    from repro_torch.models.params import leaves
    from repro_torch.train import compress as C
    F32 = torch.float32
    cs, es = C.ef_compress(g_s, ef_s)
    cp, ep = C.ef_compress(g_p, ef_p)
    scale_rel = sum_rel = quanta = flipped = 0.0
    for gs, gp, e0s, e0p, a, b, ea, eb in zip(
            *(leaves(t) for t in (g_s, g_p, ef_s, ef_p, cs, cp, es, ep))):
        xs = _full(gs).to(F32) + _full(e0s).to(F32)
        xp = gp.to(F32) + e0p.to(F32)
        amax = xp.abs().amax(-1, keepdim=True)
        scale_rel = max(scale_rel, _rel(xs.abs().amax(-1, keepdim=True),
                                        amax))
        sum_rel = max(sum_rel, _rel(_full(a).to(F32) + _full(ea).to(F32),
                                    b.to(F32) + eb.to(F32)))
        codes = (_full(a).to(F32) - b.to(F32)).abs() / (amax / 127.0)
        quanta = max(quanta, float(codes.max()))
        flipped = max(flipped, float((codes > 0.5).to(F32).mean()))
    return {"ef_scale_rel": scale_rel, "ef_sum_rel": sum_rel,
            "ef_quanta": quanta, "ef_flipped": flipped, "ef": es}


def job_fresh_state(rank, world, wd):
    """``make_state(shardings=)`` on a (2, 2) mesh (each leaf placed as it
    is made) against ``shard_state`` of the whole unplaced state, with
    plain and int8 moments and the error-feedback residuals: the same
    placements and bit-equal blocks on every rank."""
    import torch
    from repro_torch import configs
    from repro_torch import train as T
    from repro_torch.launch.shardctx import ShardCtx
    from repro_torch.models.params import leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import TRAIN_RULES

    sc = ShardCtx(_mesh((2, 2), ("data", "model")), TRAIN_RULES)
    cfg = configs.get("olmo-1b", reduced=True)
    out = {}
    for quantized in (False, True):
        opt = AdamWConfig(quantized=quantized)
        sh = sc.tree(T.abstract_state(cfg, opt, use_ef=True),
                     T.state_logical(cfg, opt, use_ef=True))
        made = T.make_state(cfg, opt, torch.Generator().manual_seed(0),
                            "cpu", use_ef=True, shardings=sh)
        want = T.shard_state(T.make_state(
            cfg, opt, torch.Generator().manual_seed(0), "cpu", use_ef=True),
            sh)
        pairs = list(zip(leaves(made), leaves(want)))
        out[f"quantized={quantized}"] = {
            "leaves": len(pairs),
            "placements": all(a.placements == b.placements
                              for a, b in pairs),
            "blocks": all(torch.equal(a.to_local(), b.to_local())
                          for a, b in pairs)}
    if rank == 0:
        (wd / "result.json").write_text(json.dumps(out))


def job_int8_psum(rank, world, wd):
    import numpy as np
    import torch
    from repro_torch.train.compress import int8_psum
    mesh = _mesh((2, 2), ("pod", "data"))
    x = torch.as_tensor(np.load(wd / "x.npy"))
    got = int8_psum(x, mesh, "pod")
    if rank == 0:
        np.save(wd / "result.npy", got.numpy())


def job_pipeline(rank, world, wd):
    import numpy as np
    import torch
    from repro_torch.sharding import pipeline_apply
    mesh = _mesh((4, 1), ("pipe", "data"))
    a = np.load(wd / "inputs.npz")
    params = {"w": torch.as_tensor(a["w"]), "b": torch.as_tensor(a["b"])}

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    got = pipeline_apply(mesh, "pipe", stage, params,
                         torch.as_tensor(a["xs"]))
    np.save(wd / f"result_{rank}.npy", got.numpy())


def job_elastic(rank, world, wd):
    """A checkpoint written from (2, 2) restored onto (4, 1) and
    unsharded: every leaf bit-equal to the state saved."""
    import torch
    from repro_torch import checkpoint, configs
    from repro_torch import train as T
    from repro_torch.ft import elastic
    from repro_torch.launch.shardctx import ShardCtx
    from repro_torch.models.params import leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import TRAIN_RULES

    cfg = configs.get("olmo-1b", reduced=True)
    opt = AdamWConfig()
    astate = T.abstract_state(cfg, opt)
    slog = T.state_logical(cfg, opt)
    state = T.make_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    mesh_a = elastic.make_mesh(list(range(world)),
                               elastic.plan_mesh(world, 2), device="cpu")
    state_a = T.shard_state(state, ShardCtx(mesh_a, TRAIN_RULES).tree(
        astate, slog))
    ckpt = str(wd / "ckpt")
    checkpoint.save(ckpt, 5, state_a)
    mesh_b = elastic.make_mesh(list(range(world)), (world, 1), device="cpu")
    state_b, at = elastic.resume_on(
        mesh_b, ckpt, astate,
        lambda m: ShardCtx(m, TRAIN_RULES).tree(astate, slog))
    same_b = all(torch.equal(_full(y), x) and x.dtype == y.dtype
                 for x, y in zip(leaves(state), leaves(state_b)))
    moved = any(x.to_local().shape != y.to_local().shape
                for x, y in zip(leaves(state_a), leaves(state_b)))
    state_c, _ = checkpoint.restore_latest(ckpt, astate)
    same_c = all(torch.equal(y, x) and x.dtype == y.dtype
                 for x, y in zip(leaves(state), leaves(state_c)))
    if rank == 0:
        (wd / "result.json").write_text(json.dumps({
            "at": at, "mesh_a": list(mesh_a.mesh.shape),
            "restored_sharded": same_b, "layout_changed": moved,
            "restored_plain": same_c}))


def job_service(rank, world, wd):
    """JAX's 16 local_affine requests through AlignmentService(mesh=) on
    a ``world``-rank 'data' mesh."""
    import numpy as np
    from repro_torch.runtime import plan as plan_mod
    from repro_torch.serve import AlignmentService, AlignRequest
    mesh = _mesh((world,), ("data",))
    a = np.load(wd / "requests.npz")
    svc = AlignmentService(max_len=64, block=8, mesh=mesh, device="cpu")
    futs = [svc.submit(AlignRequest(rid=i, kernel="local_affine",
                                    query=a["q"][i], ref=a["r"][i]))
            for i in range(len(a["q"]))]
    n = svc.drain()
    res = [f.result() for f in futs]
    placements = [k.placement for k in plan_mod.plan_cache_info()["keys"]
                  if k.placement]
    if rank == 0:
        (wd / "result.json").write_text(json.dumps({
            "drained": n, "placements": placements,
            "results": [{"score": r["score"], "end": list(r["end"]),
                         "cigar": r.get("cigar")} for r in res]}))


def job_int8_psum_one(rank, world, wd):
    """int8_psum on a one-rank 'pod' axis: the rank's own int8 round."""
    import numpy as np
    import torch
    from repro_torch.train.compress import _dq, _q, int8_psum
    mesh = _mesh((1,), ("pod",))
    x = torch.as_tensor(np.load(wd / "x.npy"))
    got = int8_psum(x, mesh, "pod")
    (wd / "result.json").write_text(json.dumps({
        "equal": bool(torch.equal(got, _dq(*_q(x)))),
        "rel": float((got - x).abs().max() / x.abs().max())}))


def job_train_loop_one(rank, world, wd):
    """train_loop on a one-rank host mesh beside the unsharded loop: the
    same losses, and a checkpoint written from the mesh restored with no
    mesh equal to the sharded state."""
    import torch
    from repro_torch import checkpoint, configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models.params import leaves

    cfg = configs.get("olmo-1b", reduced=True)
    runs = {}
    for name, mesh in (("mesh", make_host_mesh("cpu")), ("plain", None)):
        losses = []
        state, _ = train_loop(
            cfg, steps=3, batch=4, seq=32, device="cpu", mesh=mesh,
            log_every=1, ckpt_dir=str(wd / f"ck_{name}"), ckpt_every=3,
            on_metrics=lambda i, m: losses.append(float(m["loss"])))
        runs[name] = (losses, state)
    back, at = checkpoint.restore_latest(str(wd / "ck_mesh"),
                                         runs["plain"][1])
    same = all(torch.equal(y, _full(x)) for x, y in
               zip(leaves(runs["mesh"][1]), leaves(back)))
    (wd / "result.json").write_text(json.dumps({
        "mesh": runs["mesh"][0], "plain": runs["plain"][0], "at": at,
        "restored_plain": same,
        "dtensor": type(leaves(runs["mesh"][1])[0]).__name__}))


def job_decode(rank, world, wd):
    """Sharded prefill and decode steps under INFER_RULES against the
    unsharded ones, for every ``<arch>@<d>x<m>`` entry of ``archs.json``:
    the plain prefill's cache, grown to 2 x the prompt, placed as
    ``ShardCtx.tree(abstract_cache, cache_logical)`` resolves it (a mesh
    whose 'model' ranks do not divide the key/value heads splits the
    cache's slots), then two decode steps of each; the largest relative
    difference of the logits, and whether the sharded cache kept its
    placements."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.shardctx import ShardCtx
    from repro_torch.models import get_model
    from repro_torch.models.params import init_params, leaves, tree_map
    from repro_torch.sharding import INFER_RULES, place
    out = {}
    for entry in json.loads((wd / "archs.json").read_text()):
        name, _, shape = entry.partition("@")
        mesh = _mesh(tuple(int(d) for d in shape.split("x")),
                     ("data", "model"))
        sc = ShardCtx(mesh, INFER_RULES)
        cfg = configs.get(name, reduced=True)
        model = get_model(cfg)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        sparams = tree_map(place, params,
                           sc.tree(model.abstract(cfg), model.logical(cfg)))
        B, S = 4, 8
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=g)}
        _, cache, k_len = model.prefill(cfg, params, batch)
        cache = model.grow_cache(cfg, cache, B, 2 * S)
        shardings = sc.tree(model.abstract_cache(cfg, B, 2 * S),
                            model.cache_logical(cfg))
        scache = tree_map(place, cache, shardings)
        tok_sh = sc.leaf(k_len, ("batch",))
        rel = 0.0
        for _ in range(2):
            tok = torch.randint(0, cfg.vocab_size, (B,), generator=g)
            want, cache = model.decode_step(cfg, params, cache, tok, k_len)
            got, scache = model.decode_step(cfg, sparams, scache,
                                            place(tok, tok_sh),
                                            place(k_len, tok_sh), sc=sc)
            rel = max(rel, _rel(_full(got), want))
            k_len = k_len + 1
        kept = all(tuple(t.placements) == sh.placements
                   for t, sh in zip(leaves(scache), leaves(shardings)))
        out[entry] = {"rel": rel, "kept": kept}
    if rank == 0:
        (wd / "result.json").write_text(json.dumps(out))


JOBS = {name[4:]: fn for name, fn in globals().items()
        if name.startswith("job_")}


def _child(job, rank, world, wd):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(str(wd / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    try:
        JOBS[job](rank, world, wd)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
           Path(sys.argv[4]))
