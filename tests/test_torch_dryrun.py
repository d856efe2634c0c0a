"""The port's dry run (``repro_torch.launch.{specs,dryrun}``) against the JAX
package's, each in a process of its own: the port's on a fake process
group (global to its process), JAX's on 8 fake CPU devices
(``XLA_FLAGS``), as ``tests/test_multidevice.py::run_sub`` runs it.

* The cell of ``tests/test_multidevice.py::test_dryrun_cell_small_mesh``
  (reduced olmo-1b, ``train_4k`` and ``decode_32k`` at seq 256, batch 8,
  on (4, 2) 'data' x 'model'): it runs, every state, batch and cache
  leaf's sharding equals JAX's ``cell.in_shardings`` PartitionSpec and the
  placed DTensors carry its placements, and the per-device FLOPs are near
  JAX's (see ``test_flops_per_device_near_jax``).
* Every reduced architecture x shape on that mesh: ok, or skipped exactly
  where JAX's ``cell_supported`` skips.
* On a (1, 1) mesh the dry run of a training cell counts what the step
  counts on plain CPU tensors, FLOPs by dtype and kernel calls alike: the
  check ``chip_smoke.py``'s phase D makes against a step on the card.
* One full-width cell, olmo-1b ``prefill_32k``, on the 16 x 16 production
  mesh through the command line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import configs as jcfg

ROOT = Path(__file__).resolve().parent.parent
SMALL = ("train_4k", "decode_32k")


def _run(code: str, env_extra=None, timeout=600) -> dict:
    """Run ``code`` in a fresh interpreter with ``src`` on the path; its
    last stdout line is JSON."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


PORT_SMALL = r"""
import dataclasses, json
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.specs import build_cell
from repro_torch.sharding import to_placements

def flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, f"{path}['{k}']")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

dryrun.init_fake_group(8)
mesh = dryrun.small_mesh(8)
cfg = configs.get("olmo-1b", reduced=True)
out = {}
for name in %(shapes)r:
    shape = dataclasses.replace(configs.SHAPES[name], seq_len=256,
                                global_batch=8)
    cell = build_cell(cfg, shape, mesh)
    from torch._subclasses.fake_tensor import FakeTensorMode
    placed = dryrun.place_args(cell, FakeTensorMode())
    shard = dict(flat(cell.in_shardings))
    wrong = [p for p, t in flat(placed)
             if tuple(t.placements) != to_placements(shard[p].spec, mesh)]
    rec = dryrun.run_cell("olmo-1b", name, False, mesh=mesh, shape=shape,
                          cfg=cfg, verbose=False)
    out[name] = {"status": rec["status"], "error": rec.get("error"),
                 "flops": rec.get("hlo_cost", {}).get("flops_per_device"),
                 "peak": rec.get("memory", {}).get("peak_per_device"),
                 "specs": {p: spec(s) for p, s in shard.items()},
                 "wrong_placements": wrong}
print(json.dumps(out))
""" % {"shapes": SMALL}

JAX_SMALL = r"""
import dataclasses, json, jax
from repro.compat import make_mesh
from repro import configs
from repro.launch.specs import build_cell
from repro.launch import hlo_cost

mesh = make_mesh((4, 2), ('data', 'model'))
cfg = configs.get('olmo-1b', reduced=True)
out = {}
for name in %(shapes)r:
    shape = dataclasses.replace(configs.SHAPES[name], seq_len=256,
                                global_batch=8)
    cell = build_cell(cfg, shape, mesh)
    specs = jax.tree_util.tree_flatten_with_path(cell.in_shardings)[0]
    comp = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                   out_shardings=cell.out_shardings,
                   donate_argnums=cell.donate).lower(*cell.args).compile()
    out[name] = {
        "flops": hlo_cost.analyze(comp.as_text(), 8).flops,
        "specs": {jax.tree_util.keystr(p):
                  [list(e) if isinstance(e, tuple) else e for e in s.spec]
                  for p, s in specs}}
print(json.dumps(out))
""" % {"shapes": SMALL}


@pytest.fixture(scope="module")
def small():
    port = _run(PORT_SMALL)
    jax = _run(JAX_SMALL, {"XLA_FLAGS":
                           "--xla_force_host_platform_device_count=8",
                           "JAX_PLATFORMS": "cpu"})
    return port, jax


@pytest.mark.parametrize("shape", SMALL)
def test_small_mesh_cell_runs(small, shape):
    rec = small[0][shape]
    assert rec["status"] == "ok", rec["error"]
    assert rec["flops"] > 0 and rec["peak"] > 0


@pytest.mark.parametrize("shape", SMALL)
def test_placements_equal_jax_shardings(small, shape):
    port, jax = small[0][shape], small[1][shape]
    assert port["specs"] == jax["specs"]
    assert port["wrong_placements"] == []


@pytest.mark.parametrize("shape", SMALL)
def test_flops_per_device_near_jax(small, shape):
    """Per-device FLOPs of the port's counted step against XLA's count of
    JAX's partitioned program (``hlo_cost.analyze``), within 20 % below
    and 5 % above.  The products of the projections, the MLP and the head
    are the same work; the attention is not counted alike.  K3 counts its
    live (query, key) pairs, 2 (hd + hd_v) FLOPs a pair forward and 6 hd
    + 4 hd_v backward; JAX's model path scans every (q-block, k-block)
    pair its causal block test keeps, each block's scores whole, and XLA
    counts the dots of the backward its AD makes of that loop.  On this
    cell K3 is about a quarter of the port's count and JAX's attention
    about 1.7 times K3's, so the port comes out 10-17 % below JAX.  The
    decode step has no attention kernel and counts alike."""
    port, jax = small[0][shape]["flops"], small[1][shape]["flops"]
    assert 0.80 * jax <= port <= 1.05 * jax, (port, jax)


PORT_SWEEP = r"""
import dataclasses, json
from repro_torch import configs
from repro_torch.launch import dryrun
dryrun.init_fake_group(8)
mesh = dryrun.small_mesh(8)
out = {}
for arch in configs.ARCH_NAMES:
    cfg = configs.get(arch, reduced=True)
    for name in configs.SHAPES:
        # seq 256, as JAX's small-mesh cell; a reduced config whose
        # learned positions stop short of it (whisper's 128) at its own
        shape = dataclasses.replace(configs.SHAPES[name],
                                    seq_len=min(256, cfg.max_seq),
                                    global_batch=8)
        rec = dryrun.run_cell(arch, name, False, mesh=mesh, shape=shape,
                              cfg=cfg, verbose=False)
        out[f"{arch}:{name}"] = [rec["status"], rec.get("error")]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def sweep():
    return _run(PORT_SWEEP, timeout=900)


@pytest.mark.parametrize("arch,shape", [(a, s) for a in jcfg.ARCH_NAMES
                                        for s in jcfg.SHAPES])
def test_reduced_cell_ok_or_skipped_as_jax(sweep, arch, shape):
    status, error = sweep[f"{arch}:{shape}"]
    ok, _ = jcfg.cell_supported(jcfg.get(arch), jcfg.SHAPES[shape])
    assert status == ("ok" if ok else "skipped"), error


ONE_RANK = r"""
import dataclasses, json, sys, torch
from repro_torch import configs
from repro_torch.launch import dryrun, hlo_cost
from repro_torch.optim import AdamWConfig, constant
from repro_torch.train import make_state, make_train_step
arch, B, S = %(arch)r, 4, 64
cfg = configs.get(arch, reduced=True)
opt = AdamWConfig(weight_decay=0.01)
state = make_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
step = make_train_step(cfg, opt, constant(1e-4))
batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                 dtype=torch.int32)}
plain = hlo_cost.count(step, state, batch)
dryrun.init_fake_group(1)
shape = dataclasses.replace(configs.SHAPES["train_4k"], seq_len=S,
                            global_batch=B)
rec = dryrun.run_cell(arch, "train_4k", False, mesh=dryrun.small_mesh(1),
                      shape=shape, cfg=cfg, opt_cfg=opt, verbose=False)
print(json.dumps({"plain": [dict(plain.flops_by_dtype),
                            {k: v["calls"] for k, v in plain.kernels.items()}],
                  "dry": [rec["hlo_cost"]["flops_by_dtype"],
                          {k: v["calls"] for k, v in
                           rec["hlo_cost"]["kernels"].items()}]}))
"""


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-3b"])
def test_one_rank_dry_run_counts_the_plain_step(arch):
    out = _run(ONE_RANK % {"arch": arch})
    assert out["dry"] == out["plain"]
    assert sum(out["plain"][1].values()) == 4     # fwd and bwd, 2 layers


def test_full_width_cell_on_the_production_mesh(tmp_path):
    """olmo-1b ``prefill_32k`` at full width on 16 x 16 (256 fake ranks)
    through ``python -m repro_torch.launch.dryrun``: it fits, its FLOPs
    and K3 calls are counted per device, and the roofline's terms are
    recorded (predictions)."""
    out = tmp_path / "r.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmo-1b", "--shape", "prefill_32k", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["n_devices"] == 256 and rec["fits"]
    assert 0 < rec["memory"]["peak_per_device"] <= 80e9
    hc = rec["hlo_cost"]
    assert hc["kernels"]["flash_fill"]["calls"] == 16   # one a layer
    assert set(hc["flops_by_dtype"]) <= {"bf16", "f32"}
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["roofline"]["bound_s"] > 0
