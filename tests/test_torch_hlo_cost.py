"""The port's counter (``repro_torch.launch.hlo_cost``) on known programs,
the counterparts of the JAX package's HLO cost tests
(``tests/test_sharding_rules.py``), and the kernels' work formulas: each
registered kernel counts the same on CPU tensors (its plain version runs)
as under ``FakeTensorMode`` (nothing runs), and equal to its formula."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels.flash_attn import kernel as K3
from repro_torch.kernels.myers import kernel as K2
from repro_torch.kernels.wavefront import kernel as K1
from repro_torch.kernels.wkv6 import kernel as K4
from repro_torch.launch import hlo_cost

ROOT = Path(__file__).resolve().parent.parent


def test_matmul_chain_counts_2mnk_and_splits_bf16_from_f32():
    a = torch.randn(64, 32, dtype=torch.bfloat16)
    b = torch.randn(32, 16, dtype=torch.bfloat16)
    c = torch.randn(16, 8)
    cost = hlo_cost.count(lambda: (a @ b).float() @ c)
    assert dict(cost.flops_by_dtype) == {"bf16": 2 * 64 * 32 * 16,
                                         "f32": 2 * 64 * 16 * 8}
    assert cost.flops == 2 * 64 * 32 * 16 + 2 * 64 * 16 * 8
    # each product reads its inputs and writes its output; the cast too
    assert cost.bytes == (2 * (64 * 32 + 32 * 16 + 64 * 16)
                          + (2 + 4) * 64 * 16
                          + 4 * (64 * 16 + 16 * 8 + 64 * 8))


def test_tf32_setting_books_f32_products_as_tf32():
    a = torch.randn(8, 8)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        cost = hlo_cost.count(lambda: a @ a)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert dict(cost.flops_by_dtype) == {"tf32": 2 * 8 ** 3}


def test_loop_of_15_matmuls_counts_15_times():
    """Eager code runs every iteration: JAX's while-loop trip counts have
    no counterpart to recover (cf. ``test_hlo_cost_nested_scan``)."""
    w = torch.randn(32, 32)

    def f(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x
    assert hlo_cost.count(f, torch.randn(32, 32)).flops == 15 * 2 * 32 ** 3


def test_linear_chain_gradient_counts_three_times_its_forward():
    x = torch.randn(8, 16, requires_grad=True)
    w1 = torch.randn(16, 32, requires_grad=True)
    w2 = torch.randn(32, 4, requires_grad=True)

    def fwd():
        return (x @ w1) @ w2

    def step():
        torch.autograd.grad(fwd().sum(), [x, w1, w2])
    f = hlo_cost.count(fwd).flops
    assert f == 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4
    assert hlo_cost.count(step).flops == 3 * f


def test_pointwise_ops_count_ewise_and_views_move_no_bytes():
    x = torch.randn(10, 20)
    cost = hlo_cost.count(lambda: torch.tanh(x.t().reshape(20, 10)) + 1)
    assert cost.ewise_flops == 2 * 200
    assert cost.flops == 0
    # tanh reads and writes 200 f32; the add reads 200 and writes 200
    # (the view and the reshape of a contiguous transpose copy once)
    assert cost.bytes >= 4 * 4 * 200


def test_host_transfers_are_recorded():
    x = torch.randn(4)
    cost = hlo_cost.count(lambda: float(x.sum()))
    assert [op for op, _ in cost.host_transfers] == ["_local_scalar_dense"]


def test_breakdown_books_each_op_to_the_ports_function():
    q = torch.randn(1, 70, 2, 16)
    rows = hlo_cost.breakdown(
        lambda: K3.flash_fill(q, q, q, causal=True) @ torch.randn(16, 8))
    labels = {r[0]: r for r in rows}
    k3 = labels["kernels/flash_attn/kernel.py:flash_fill"]
    assert k3[1] == 4 * 16 * K3.k3_pairs(70, True, None, None) * 2
    assert "(autograd backward)" not in labels or len(labels) >= 2


# ---------------------------------------------------------------------------
# Kernels: one shapes-only formula, the same count everywhere
# ---------------------------------------------------------------------------
def _k3_args(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 100, 4, 32, generator=g).to(dtype)
    k = torch.randn(2, 130, 2, 32, generator=g).to(dtype)
    v = torch.randn(2, 130, 2, 32, generator=g).to(dtype)
    return q, k, v


def _k3_fwd(q, k, v):
    return K3.flash_fill(q, k, v, causal=True, window=48, q_start=30,
                         p_dtype=v.dtype, return_lse=True)


def _k3_bwd(q, k, v):
    o = torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=q.dtype)
    lse = torch.zeros(q.shape[:3])
    return K3.flash_backward(q, k, v, o, lse, torch.ones_like(o),
                             causal=True, window=48, q_start=30)


def _k4_args():
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(2, 70, 3, 16, generator=g) for _ in range(3))
    lw = -torch.rand(2, 70, 3, 16, generator=g)
    return r, k, v, lw, torch.randn(3, 16, generator=g)


def _k4_bwd(r, k, v, lw, u):
    return K4.wkv6_backward(r, k, v, lw, u, torch.ones_like(r))


def _k1_args():
    from repro_torch.core import kernels_zoo
    spec, params = kernels_zoo.make("global_affine")
    B, Q, R, L = 3, 64, 40, spec.n_layers
    dt = spec.score_dtype
    return spec, params, (torch.zeros((B, Q), dtype=torch.uint8),
                          torch.zeros((B, R), dtype=torch.uint8),
                          torch.zeros((B, R + 1, L), dtype=dt),
                          torch.zeros((B, Q + 1, L), dtype=dt),
                          torch.tensor([[Q, R]] * B, dtype=torch.int32))


def _k1(spec, params, *args):
    return K1.wavefront_fill(spec, params, *args, tb_pack=2)


def _k2_args():
    B, Q, R = 4, 100, 70
    return (torch.zeros((B, Q), dtype=torch.uint8),
            torch.zeros((B, R), dtype=torch.uint8),
            torch.tensor([[Q, R]] * B, dtype=torch.int32))


def _expected(name):
    """(work by peak class, bytes) from each kernel's formula as the
    module states it, computed here from the shapes."""
    from repro_torch.tune.cost import k1_bytes, pe_ops
    if name in ("flash_fill", "flash_backward"):
        pairs = K3.k3_pairs(100, True, 48, None, 130, 30)
        per = 2 * (32 + 32) if name == "flash_fill" else 6 * 32 + 4 * 32
        return {"f32": per * pairs * 2 * 4}
    if name == "wkv6_fill":
        return {"f32": K4.k4_ops_per_step(16) * 70 * 2 * 3}
    if name == "wkv6_backward":
        return {"f32": K4.k4_bwd_ops_per_chunk(16) * 3 * 2 * 3}
    if name == "wavefront_fill":
        spec, _, _ = _k1_args()
        return {"int32": pe_ops(spec) * 3 * 64 * 40}, \
            k1_bytes(spec, 3, 64, 40, 2)
    return {"int32": K2.OPS_PER_WORD_COLUMN * K2.n_words(100) * 70 * 4}


CASES = {
    "flash_fill": (_k3_fwd, _k3_args),
    "flash_backward": (_k3_bwd, _k3_args),
    "wkv6_fill": (lambda *a: K4.wkv6_fill(*a, return_states=True),
                  _k4_args),
    "wkv6_backward": (_k4_bwd, _k4_args),
    "wavefront_fill": (lambda s, p, a: _k1(s, p, *a), _k1_args),
    "myers_fill": (lambda *a: K2.myers_fill(*a, glob=False, k=5), _k2_args),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_counts_its_formula_on_cpu_and_under_fake_tensors(name):
    fn, make = CASES[name]
    args = make()
    on_cpu = hlo_cost.count(fn, *args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                tuple(mode.from_tensor(t) for t in a)
                if isinstance(a, tuple) else a for a in args]
        under_fake = hlo_cost.count(fn, *fake)
    want = _expected(name)
    want_ops = want[0] if isinstance(want, tuple) else want
    assert on_cpu.kernels == under_fake.kernels
    rec = on_cpu.kernels[name]
    assert rec["calls"] == 1 and rec["ops"] == want_ops
    if isinstance(want, tuple):
        assert rec["bytes"] == want[1]
    # while the kernel runs nothing else is counted: the plain version's
    # ops stay inside it
    assert dict(on_cpu.flops_by_dtype) == want_ops
    assert on_cpu.ewise_flops == under_fake.ewise_flops == 0


def test_k3_bf16_counts_on_the_tensor_cores():
    cost = hlo_cost.count(_k3_fwd, *_k3_args(torch.bfloat16))
    assert list(cost.kernels["flash_fill"]["ops"]) == ["bf16"]


@pytest.mark.parametrize("kernel", ["global_linear", "local_affine"])
def test_analyze_plan_counts_k1_by_the_tuners_formula(kernel):
    from repro_torch.core import kernels_zoo
    from repro_torch.tune.cost import k1_bytes, pe_ops
    spec, params = kernels_zoo.make(kernel)
    B, Q, R = 3, 50, 40
    cost = hlo_cost.analyze_plan(spec, params, "wavefront", (Q,), (R,),
                                 batch_size=B, with_traceback=True)
    k1 = cost.kernels["wavefront_fill"]
    Qp = -(-Q // K1.N_PE) * K1.N_PE
    assert k1["calls"] == 1
    assert k1["ops"] == {"int32": pe_ops(spec) * B * Qp * R}
    assert k1["bytes"] == k1_bytes(spec, B, Qp, R, _tb_pack(spec))
    assert cost.bytes > k1["bytes"]          # the traceback's own passes


def _tb_pack(spec):
    from repro_torch.runtime import plan as plan_mod
    return plan_mod.resolve_engine_options(spec, "wavefront", {},
                                           "cpu")["tb_pack"]


def test_sharded_product_counts_the_ranks_share_and_one_all_gather():
    """Over DTensors on a 16 x 16 fake mesh (a fake process group of 256
    ranks, in a process of its own): the (4096 x 8192) x (8192 x 1024)
    bf16 product split (Shard(0), Replicate) x (Replicate, Shard(1))
    counts rank 0's 2 x 256 x 8192 x 64 FLOPs, not the global op's; making
    its columns whole is one all-gather over the 16 ranks of 'model' of
    the (256, 1024) bf16 block, a group that spans two 8-card nodes."""
    code = r"""
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import dryrun, hlo_cost
dryrun.init_fake_group(256)
mesh = torch.distributed.device_mesh.init_device_mesh(
    "cpu", (16, 16), mesh_dim_names=("data", "model"))
with FakeTensorMode() as fm:
    a = torch.empty(256, 8192, dtype=torch.bfloat16)
    b = torch.empty(8192, 64, dtype=torch.bfloat16)
A = DTensor.from_local(a, mesh, (Shard(0), Replicate()), run_check=False)
B = DTensor.from_local(b, mesh, (Replicate(), Shard(1)), run_check=False)
cost = hlo_cost.count(lambda: torch.matmul(A, B).redistribute(
    mesh, (Shard(0), Replicate())), warm=True)
print(json.dumps({"flops": dict(cost.flops_by_dtype),
                  "coll": cost.collectives}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["flops"] == {"bf16": 2 * 256 * 8192 * 64}
    assert out["coll"] == [["all-gather", 256 * 1024 * 2, 16, 1.0, 2]]
