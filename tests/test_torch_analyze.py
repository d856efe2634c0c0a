"""The port's plan linter (``repro_torch.analyze``): every kept rule fires
on a seeded defect and stays silent on the healthy registry, beside the
JAX package's linter where both judge the same fixture.

Fixtures ``dataclasses.replace`` a real zoo spec with one deliberate defect
and lint that single point with the rule under test selected, so each test
shows that the rule fires and why."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import analyze
from repro_torch.analyze import lint as lint_mod
from repro_torch.analyze import rules as rules_mod
from repro_torch.core import kernels_zoo as pzoo
from repro_torch.core import types as T
from repro_torch.runtime import registry

CPU = analyze.LintConfig(device="cpu")


def _point(spec, params, engine="reference", bucket=(32, 32), batch=2):
    return analyze.point_for(spec, params, engine, bucket, batch)


def _findings(spec, params, rule, engine="reference", bucket=(32, 32),
              batch=2, config=CPU):
    report = analyze.lint_point(_point(spec, params, engine, bucket, batch),
                                rules=[rule], config=config)
    return [f for f in report.findings if f.rule == rule]


# ---------------------------------------------------------------------------
# R1xx — recurrence legality
# ---------------------------------------------------------------------------
def test_r101_fires_on_wrong_pe_shape():
    spec, params = pzoo.make("global_linear")

    def bad_pe(p, q, r, diag, up, left, i, j):   # 2 layers for n_layers=1
        s, ptr = spec.pe(p, q, r, diag, up, left, i, j)
        return torch.cat([s, s], dim=-1), ptr

    found = _findings(dataclasses.replace(spec, pe=bad_pe), params, "R101")
    assert found and all(f.severity == analyze.ERROR for f in found)
    assert "n_layers" in found[0].message


def test_r101_fires_on_pe_dtype_mismatch():
    spec, params = pzoo.make("global_linear")      # int32 scores

    def float_pe(p, q, r, diag, up, left, i, j):
        s, ptr = spec.pe(p, q, r, diag, up, left, i, j)
        return s.to(torch.float32), ptr

    found = _findings(dataclasses.replace(spec, pe=float_pe), params, "R101")
    assert found and "score_dtype" in found[0].message


def test_r101_fires_on_float_init_for_int_scores():
    spec, params = pzoo.make("global_linear")
    bad = dataclasses.replace(
        spec, init_row=lambda p, j: j.to(torch.float32)[:, None] * 0.5)
    found = _findings(bad, params, "R101")
    assert found and "truncates" in found[0].message


def test_r101_clean_on_every_zoo_kernel():
    for kid in pzoo.KERNELS:
        spec, params = pzoo.make(kid)
        assert not _findings(spec, params, "R101"), spec.name


def test_r102_fires_on_unreachable_band_as_jax_does():
    from repro import analyze as janalyze
    from repro.core import kernels_zoo as jzoo
    spec, params = pzoo.make("banded_global_linear")     # band 16
    jspec, jparams = jzoo.make("banded_global_linear")
    for bucket, fires in (((32, 128), True), ((64, 64), False)):
        found = _findings(spec, params, "R102", engine="banded",
                          bucket=bucket)
        jrep = janalyze.lint_point(
            janalyze.point_for(jspec, jparams, "banded", bucket, 2),
            rules=["R102"])
        assert bool(found) == fires == bool(jrep.errors)
        if fires:
            assert found[0].severity == analyze.ERROR
            assert found[0].message == jrep.errors[0].message


def test_r103_fires_on_non_unit_cost_pe():
    spec, params = pzoo.make("edit_distance")

    def weighted_pe(p, q, r, diag, up, left, i, j):   # mismatch costs 2
        sub = diag[:, 0] + torch.where(q == r, 0, 2)
        best = torch.minimum(sub, torch.minimum(up[:, 0] + 1, left[:, 0] + 1))
        return best[:, None].to(torch.int32), torch.zeros_like(best)

    found = _findings(dataclasses.replace(spec, pe=weighted_pe), params,
                      "R103", engine="myers")
    assert found and found[0].severity == analyze.ERROR
    assert "unit-cost" in found[0].message
    assert not _findings(spec, params, "R103", engine="myers")


def test_r103_fires_on_wrong_boundary_init():
    spec, params = pzoo.make("edit_distance")
    bad = dataclasses.replace(
        spec, init_col=lambda p, idx: torch.zeros_like(idx)[:, None])
    found = _findings(bad, params, "R103", engine="myers")
    assert found and "init_col" in found[0].message


# ---------------------------------------------------------------------------
# R2xx — cache-key and dtype hazards
# ---------------------------------------------------------------------------
def test_r201_fires_on_unhashable_spec():
    spec, params = pzoo.make("dtw")
    bad = dataclasses.replace(spec, char_shape=[2])    # list: unhashable
    found = _findings(bad, params, "R201")
    assert found and found[0].severity == analyze.ERROR
    assert "unhashable" in found[0].message


def test_r202_fires_when_the_fill_drifts_from_the_declared_dtype():
    """An engine whose fill computes f32 for an int32 kernel."""
    def f32_engine(spec, params, q, r, ql, rl, *, with_tb=True):
        zero = torch.zeros((q.shape[0],), dtype=torch.int32)
        return T.DPResult(score=zero.to(torch.float32), end_i=zero,
                          end_j=zero)

    registry.register_engine("lint_f32", fn=f32_engine, traceback=False,
                             overwrite=True)
    try:
        spec, params = pzoo.make("global_linear")
        found = _findings(spec, params, "R202", engine="lint_f32")
        assert found and found[0].severity == analyze.ERROR
        assert "float32" in found[0].message
        assert not _findings(spec, params, "R202", engine="wavefront")
    finally:
        registry.unregister_engine("lint_f32")


def test_r203_fires_on_64_bit_param_leaves():
    spec, params = pzoo.make("protein_local")
    assert not _findings(spec, params, "R203")
    wide = dict(params, sub=params["sub"].to(torch.int64))
    found = _findings(spec, wide, "R203")
    assert found and found[0].severity == analyze.WARNING
    assert "int64" in found[0].message
    found = _findings(spec, dict(params, drift=np.float64(1.5)), "R203")
    assert found and "float64" in found[0].message


# ---------------------------------------------------------------------------
# R3xx — transfers: where the program waits for the device
# ---------------------------------------------------------------------------
def _chatty(pe, how):
    def chatty_pe(p, q, r, diag, up, left, i, j):
        if how == "item":
            i[0].item()
        else:
            print("cell", i, j)
        return pe(p, q, r, diag, up, left, i, j)
    return chatty_pe


@pytest.mark.parametrize("how", ["item", "print"])
def test_r301_fires_on_host_read_in_pe(how):
    spec, params = pzoo.make("global_linear")
    assert not _findings(spec, params, "R301")
    bad = dataclasses.replace(spec, pe=_chatty(spec.pe, how))
    found = _findings(bad, params, "R301")
    assert found and all(f.severity == analyze.ERROR for f in found)
    op = "item" if how == "item" else "repr"
    assert op in found[0].message and "test_torch_analyze.py" in \
        found[0].message


def test_r302_fires_on_large_captured_tensor():
    spec, params = pzoo.make("global_linear")
    assert not _findings(spec, params, "R302")
    baked = torch.zeros((512, 512), dtype=torch.float32)        # 1 MiB

    def leaky_pe(p, q, r, diag, up, left, i, j):
        s, ptr = spec.pe(p, q, r, diag, up, left, i, j)
        return s + baked[0, 0].to(s.dtype), ptr

    bad = dataclasses.replace(spec, pe=leaky_pe)
    found = _findings(bad, params, "R302")
    assert found and found[0].severity == analyze.WARNING
    assert "baked" in found[0].message and "[512, 512]" in found[0].message
    # over the error threshold the same capture is fatal
    cfg = analyze.LintConfig(device="cpu", const_error_bytes=1 << 20)
    found = _findings(bad, params, "R302", config=cfg)
    assert found and found[0].severity == analyze.ERROR


# where the port's eager program reads the device on the host: the walk's
# early exit on every +tb point, the eager engines' fill bound
R303_SITES = {"core/traceback.py:180:run_batched",
              "core/reference.py:84:sweep",
              "core/banded.py:67:run"}


def test_r303_sites_over_the_default_sweep():
    points, _ = analyze.enumerate_points()
    report = analyze.lint_all(rules=["R303"], config=CPU, points=points)
    by_point = {}
    for f in report.findings:
        assert f.rule == "R303" and f.severity == analyze.WARNING
        assert "runtime/plan.py" not in f.message
        site = f.message.split("host read at ", 1)[1].split(":", 3)
        by_point.setdefault(f.where, set()).add(":".join(site[:3]))
    for p in points:
        want = set()
        if p.with_traceback:
            want.add("core/traceback.py:180:run_batched")
        if p.engine == "reference":
            want.add("core/reference.py:84:sweep")
        if p.engine == "banded":
            want.add("core/banded.py:67:run")
        assert by_point.get(p.label, set()) == want, p.label
    assert set().union(*by_point.values()) == R303_SITES


def test_r303_off_without_hlo_rules():
    spec, params = pzoo.make("global_linear")
    cfg = analyze.LintConfig(device="cpu", hlo_rules=False)
    assert _findings(spec, params, "R303")
    assert not _findings(spec, params, "R303", config=cfg)


@pytest.mark.parametrize("kernel", [name for (name, _, _)
                                    in pzoo.KERNELS.values()])
def test_r301_r302_match_jax_on_the_xla_engines(kernel):
    """Per (kernel, engine) of the XLA engines both packages register, the
    port's R301 and R302 findings equal JAX's (JAX without its HLO rules
    and its Pallas engines)."""
    from repro import analyze as janalyze
    from repro.runtime import registry as jregistry
    engines = [e for e in ("reference", "wavefront", "banded", "myers")
               if e in registry.available_engines()
               and e in jregistry.available_engines()]
    port = analyze.lint_all(kernels=[kernel], engines=engines,
                            rules=["R301", "R302"], config=CPU)
    jax = janalyze.lint_all(kernels=[kernel], engines=engines,
                            rules=["R301", "R302"],
                            config=janalyze.LintConfig(hlo_rules=False))
    assert port.points and jax.points

    def kernel_of(where):
        return where.split("×", 1)[0]
    assert {(f.rule, kernel_of(f.where)) for f in port.findings} == \
        {(f.rule, kernel_of(f.where)) for f in jax.findings} == set()


# ---------------------------------------------------------------------------
# R4xx — K1's budgets and the traceback store
# ---------------------------------------------------------------------------
def test_r401_fires_on_shared_memory_overflow():
    spec, params = pzoo.make("global_linear")
    found = _findings(spec, params, "R401", engine="wavefront",
                      bucket=(64, 1 << 17))
    errors = [f for f in found if f.severity == analyze.ERROR]
    assert errors and "shared memory" in errors[0].message
    found = _findings(spec, params, "R401", engine="wavefront",
                      bucket=(64, 64))
    assert not [f for f in found if f.severity != analyze.INFO]
    tight = analyze.LintConfig(device="cpu", smem_budget_bytes=1024)
    found = _findings(spec, params, "R401", engine="wavefront",
                      bucket=(64, 64), config=tight)
    assert any(f.severity == analyze.ERROR for f in found)


def test_r401_reports_ptxas_or_says_it_has_none(monkeypatch):
    from repro_torch.kernels import build
    spec, params = pzoo.make("global_linear")
    monkeypatch.setattr(build, "kept_report",
                        lambda source, include_dirs=(): None)
    found = _findings(spec, params, "R401", engine="wavefront")
    assert [f.severity for f in found] == [analyze.INFO]
    assert "no ptxas report" in found[0].message
    log = ("ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
           "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
           "loads\nptxas info    : Used 255 registers\n")
    monkeypatch.setattr(build, "kept_report",
                        lambda source, include_dirs=(): log)
    found = _findings(*pzoo.make("edit_distance"), "R401", engine="myers")
    assert any(f.severity == analyze.WARNING and "spills 16 bytes"
               in f.message for f in found)
    assert any("255-255 registers" in f.message for f in found)


def test_r402_fires_on_illegal_grid():
    spec, params = pzoo.make("global_linear")
    ctx = analyze.PointContext(_point(spec, params, "wavefront", (64, 64)))
    ctx.__dict__["options"] = dict(ctx.options, tb_pack=3)   # 3 ∤ 32
    found = list(rules_mod.rule_k1_grid(ctx, CPU))
    assert any(f.severity == analyze.ERROR and "tb_pack" in f.message
               for f in found)
    ctx = analyze.PointContext(_point(spec, params, "wavefront", (64, 64)))
    ctx.__dict__["options"] = dict(ctx.options, strip_warps=8)  # 2 strips
    found = list(rules_mod.rule_k1_grid(ctx, CPU))
    assert any(f.severity == analyze.ERROR and "strip_warps" in f.message
               for f in found)
    found = _findings(spec, params, "R402", engine="wavefront",
                      bucket=(48, 64))
    assert [f.severity for f in found] == [analyze.INFO]
    assert "pads to 64" in found[0].message


def test_r403_fires_on_traceback_budget():
    spec, params = pzoo.make("global_linear")
    cfg = analyze.LintConfig(device="cpu", tb_budget_bytes=1024)
    found = _findings(spec, params, "R403", engine="wavefront",
                      bucket=(64, 64), batch=8, config=cfg)
    assert found and found[0].severity == analyze.WARNING
    assert "traceback" in found[0].message


# ---------------------------------------------------------------------------
# R5xx — registry hygiene (global scope)
# ---------------------------------------------------------------------------
def _global_findings(rule):
    report = analyze.lint_all(points=[], rules=[rule], config=CPU)
    return [f for f in report.findings if f.rule == rule]


def test_r501_fires_on_broken_semiring(monkeypatch):
    from repro_torch.core import semiring as S
    broken = S.Semiring("subtract", lambda a, b: a - b,   # not commutative
                        lambda x, axis=None: torch.sum(x),
                        lambda x, axis=None: torch.argmax(x),
                        selective=False)
    monkeypatch.setitem(S.BY_OBJECTIVE, "subtract", broken)
    found = _global_findings("R501")
    assert any("subtract" in f.where for f in found)
    assert all(f.severity == analyze.ERROR for f in found)


def test_r501_clean_on_builtin_semirings():
    assert not _global_findings("R501")


def test_r502_fires_on_bad_tunable_grid():
    registry.register_engine(
        "lint_bad_grid", lambda *a, **k: None,
        options={"strip_warps": None}, tunable={"strip_warps": (0, 8)},
        overwrite=True)
    try:
        found = _global_findings("R502")
        assert found and all(f.severity == analyze.ERROR for f in found)
        assert any("lint_bad_grid" in f.where for f in found)
    finally:
        registry.unregister_engine("lint_bad_grid")
    assert not _global_findings("R502")


def test_tunable_must_be_declared():
    with pytest.raises(ValueError, match="not declared"):
        registry.register_engine("lint_undeclared", lambda *a, **k: None,
                                 tunable={"strip_warps": (1, 2)})


def test_r503_fires_on_non_plankey_option():
    registry.register_engine(
        "lint_bad_opt", lambda *a, **k: None,
        options={"blocksize": 4}, overwrite=True)   # not a PlanKey field
    try:
        found = _global_findings("R503")
        assert found and "blocksize" in found[0].message
    finally:
        registry.unregister_engine("lint_bad_opt")
    assert not _global_findings("R503")


# ---------------------------------------------------------------------------
# sweep plumbing
# ---------------------------------------------------------------------------
def test_enumerate_points_derives_from_registries():
    points, skipped = analyze.enumerate_points(bucket=(64, 64))
    pairs = {(p.kernel, p.engine) for p in points}
    assert ("global_linear", "wavefront") in pairs
    assert ("edit_distance", "myers") in pairs
    assert ("global_linear", "banded") not in pairs
    assert any("global_linear×banded" in s for s in skipped)
    by = {(p.kernel, p.engine): p for p in points}
    assert by[("global_linear", "wavefront")].with_traceback
    assert not by[("edit_distance", "myers")].with_traceback


def test_registry_sweep_is_clean():
    """The whole port registry at the default bucket and batch: no error
    finding on the CPU, R303's host reads warnings only."""
    report = analyze.lint_all(config=CPU)
    assert report.ok, report.format_text(verbose=True)
    assert report.points > 30 and not report.errors
    assert any(f.rule == "R303" for f in report.findings)


def test_select_rules_prefixes():
    ids = {r.id for r in analyze.select_rules(["R4"])}
    assert ids == {"R401", "R402", "R403"}
    ids = {r.id for r in analyze.select_rules(["R3"])}
    assert ids == {"R301", "R302", "R303"}
    ids = {r.id for r in analyze.select_rules(None, ignore=["R4", "R5"])}
    assert ids and not any(i.startswith(("R4", "R5")) for i in ids)
    with pytest.raises(ValueError, match="unknown rule"):
        analyze.select_rules(["R9"])


def test_crashing_rule_is_reported_not_swallowed():
    spec, params = pzoo.make("global_linear")
    report = analyze.Report()
    bad_rule = lint_mod.Rule("R101", "boom", analyze.ERROR, "point",
                             lambda ctx, cfg: 1 / 0)
    lint_mod._run_rule(bad_rule, report,
                       analyze.PointContext(_point(spec, params)), CPU)
    assert report.errors and "crashed" in report.errors[0].message


def test_report_json_roundtrip():
    report = analyze.lint_all(kernels=["dtw"], engines=["reference"],
                              config=CPU)
    blob = json.loads(report.to_json())
    assert blob["points"] == 1
    assert set(blob["counts"]) == {"error", "warning", "info"}
    assert isinstance(blob["findings"], list)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_cli_exit_codes_and_json(capsys):
    from repro_torch.analyze.__main__ import main
    rc = main(["--kernels", "dtw", "--engines", "reference", "--device",
               "cpu", "--json"])
    blob = json.loads(capsys.readouterr().out)
    assert rc == 0 and blob["counts"]["error"] == 0

    rc = main(["--kernels", "11", "--engines", "banded", "--bucket",
               "32x128", "--device", "cpu"])
    assert rc == 1 and "R102" in capsys.readouterr().out

    rc = main(["--list-rules"])
    out = capsys.readouterr().out
    assert rc == 0 and "R101" in out and "R503" in out

    assert main(["--rules", "R9x"]) == 2
    assert main(["--kernels", "no_such_kernel"]) == 2


def test_cli_no_hlo_skips_r303(capsys):
    from repro_torch.analyze.__main__ import main
    args = ["--kernels", "global_linear", "--engines", "reference",
            "--device", "cpu", "--rules", "R3", "--json"]
    assert main(args) == 0
    rules = {f["rule"] for f in json.loads(capsys.readouterr().out)
             ["findings"]}
    assert rules == {"R303"}
    assert main(args + ["--no-hlo"]) == 0
    assert not json.loads(capsys.readouterr().out)["findings"]
