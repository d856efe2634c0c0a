"""The port's roofline (``repro_torch.launch.roofline``) and dry-run shapes
(``repro_torch.configs.SHAPES``, ``cell_supported``) against the JAX
package's: the analytic counts equal JAX's on every architecture and
shape to rel 1e-12, the ring-model wire bytes equal JAX's, and the terms
the port changes for the H100 (compute by dtype, two links) and the plan
roofline's trip scaling."""
from __future__ import annotations

import pytest

from repro import configs as jcfg
from repro.launch import roofline as jrl
from repro_torch import configs as pcfg
from repro_torch.launch import roofline as prl

ARCHS = list(jcfg.ARCH_NAMES)
SHAPES = list(jcfg.SHAPES)
REL = 1e-12


def test_arch_names_and_shapes_equal_jax():
    assert sorted(pcfg.ARCH_NAMES) == sorted(jcfg.ARCH_NAMES)
    assert list(pcfg.SHAPES) == list(jcfg.SHAPES)
    for name, s in jcfg.SHAPES.items():
        p = pcfg.SHAPES[name]
        assert (p.name, p.seq_len, p.global_batch, p.kind) == \
            (s.name, s.seq_len, s.global_batch, s.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_jax(arch):
    jc, pc = jcfg.get(arch), pcfg.get(arch)
    for active in (False, True):
        for padded in (False, True):
            want = jrl.param_count(jc, active=active, padded=padded)
            got = prl.param_count(pc, active=active, padded=padded)
            assert got == pytest.approx(want, rel=REL), (active, padded)


@pytest.mark.parametrize("arch,shape", [(a, s) for a in ARCHS
                                        for s in SHAPES])
def test_model_flops_attn_flops_and_support_match_jax(arch, shape):
    jc, pc = jcfg.get(arch), pcfg.get(arch)
    js, ps = jcfg.SHAPES[shape], pcfg.SHAPES[shape]
    assert prl.model_flops(pc, ps) == pytest.approx(
        jrl.model_flops(jc, js), rel=REL)
    assert prl.attn_flops(pc, ps) == pytest.approx(
        jrl.attn_flops(jc, js), rel=REL)
    assert pcfg.cell_supported(pc, ps) == jcfg.cell_supported(jc, js)


@pytest.mark.parametrize("op", ["all-gather", "reduce-scatter", "all-reduce",
                                "all-to-all", "collective-permute"])
@pytest.mark.parametrize("group", [1, 2, 16])
def test_wire_bytes_matches_jax(op, group):
    recs = [(op, 1000.0, group, 1.0), (op, 4096.0, group, 3.0)]
    assert prl.wire_bytes(recs) == pytest.approx(jrl.wire_bytes(recs),
                                                 rel=REL)
    dicts = [{"op": o, "payload_bytes": b, "group": g, "trips": t}
             for o, b, g, t in recs]
    assert prl.wire_bytes(dicts) == pytest.approx(jrl.wire_bytes(dicts),
                                                  rel=REL)


def test_collective_term_picks_nvlink_within_a_node_else_the_network():
    inside = {"op": "all-reduce", "payload_bytes": 1e9, "group": 8,
              "trips": 1.0, "nodes": 1}
    across = dict(inside, group=16, nodes=2)
    assert prl.collective_seconds([inside]) == pytest.approx(
        2 * 7 / 8 * 1e9 / prl.NVLINK_BW)
    assert prl.collective_seconds([across]) == pytest.approx(
        2 * 15 / 16 * 1e9 / prl.NET_BW)


def test_compute_term_sums_each_dtype_over_its_peak():
    rec = {"mesh": "16x16", "n_devices": 256,
           "hlo_cost": {"flops_per_device": 3e12,
                        "flops_by_dtype": {"bf16": 1e12, "f32": 1e12,
                                           "tf32": 1e12},
                        "bytes_per_device": 3.35e12, "collectives": []}}
    cfg, shape = pcfg.get("olmo-1b"), pcfg.SHAPES["train_4k"]
    r = prl.from_record(rec, cfg, shape)
    assert r.compute_s == pytest.approx(1e12 / 989e12 + 1e12 / 67e12
                                        + 1e12 / 495e12)
    assert r.memory_s == pytest.approx(1.0)
    assert r.dominant == "memory" and r.bound_s == pytest.approx(1.0)
    assert r.hlo_flops_global == pytest.approx(3e12 * 256)


def test_gpu_backend_peaks_are_the_tuners_constants():
    from repro_torch.tune import cost
    peak, bw = prl.BACKEND_PEAKS["gpu"]
    assert peak == cost.H100.sms * cost.INT32_LANES_PER_SM * \
        cost.H100.clock_hz
    assert bw == cost.MEM_BYTES_PER_S == 3.35e12


def test_plan_roofline_scales_by_trips():
    """The counterpart of JAX's ``test_roofline_scales_by_analytic_trips``
    on the port's ``analyze_plan``."""
    from repro_torch.core import kernels_zoo
    from repro_torch.launch import hlo_cost
    spec, params = kernels_zoo.make("global_linear")
    Q, R = 32, 48
    cost = hlo_cost.analyze_plan(spec, params, "wavefront", (Q,), (R,),
                                 batch_size=2, with_traceback=False,
                                 mode="fill")
    one = prl.plan_roofline(cost, Q * R * 2, trips=1.0)
    two = prl.plan_roofline(cost, Q * R * 2, trips=2.0)
    assert two.compute_s == pytest.approx(2 * one.compute_s)
    assert two.memory_s == pytest.approx(2 * one.memory_s)
    assert one.cells_per_s > two.cells_per_s
    assert one.compute_s > 0 and one.memory_s > 0
