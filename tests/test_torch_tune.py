"""The port's autotuner (``repro_torch.tune``): the design space, the
analytic cost ranking, the table and its key, the ``get_plan`` lookup, the
option validators and the search, on the CPU against the plain versions,
beside the JAX package's ``repro.tune`` where the two share a contract."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch import tune
from repro_torch.core import kernels_zoo as pzoo
from repro_torch.kernels.wavefront import kernel as K1
from repro_torch.kernels.wavefront import ops as k1_ops
from repro_torch.runtime import plan as plan_mod
from repro_torch.tune import cost


@pytest.fixture(autouse=True)
def _isolate_table(monkeypatch):
    """No test sees a developer's env or table, and none leaks one."""
    monkeypatch.delenv(tune.ENV_VAR, raising=False)
    tune.set_table(None)
    yield
    tune.set_table(None)


@pytest.fixture(scope="module")
def linear():
    return pzoo.make("global_linear")


# ---------------------------------------------------------------------------
# space: derived, validated, deduplicated
# ---------------------------------------------------------------------------
class TestSpace:
    def test_grid_derived_from_registry(self, linear):
        spec, _ = linear
        cands = tune.enumerate_space(spec, "wavefront", device="cpu")
        # {1, 2, 4} legal tb_packs for 2-bit pointers (8 leaves 1-bit
        # slots) x 4 warps counts
        assert len(cands) == 12
        assert all(set(c) == {"strip_warps", "tb_pack"} for c in cands)
        assert tune.default_options(spec, "wavefront", "cpu") == \
            {"strip_warps": None, "tb_pack": spec.tb_pack}

    def test_bucket_drops_unlaunchable_warps(self, linear):
        spec, _ = linear
        cands = tune.enumerate_space(spec, "wavefront", (64, 64), "cpu")
        assert {c["strip_warps"] for c in cands} == {1, 2}   # 2 strips
        assert len(tune.enumerate_space(spec, "wavefront", (48, 64),
                                        "cpu")) == 6         # pads to 64

    def test_illegal_points_dropped(self):
        spec, _ = pzoo.make("global_affine")   # 4-bit pointers
        cands = tune.enumerate_space(spec, "wavefront", device="cpu")
        assert cands and all(c["tb_pack"] in (1, 2) for c in cands)

    def test_score_only_collapses_tb_axis(self):
        from repro_torch.prob import kernels as prob_kernels
        spec = prob_kernels.cached_pairhmm()
        assert spec.traceback is None
        cands = tune.enumerate_space(spec, "wavefront", device="cpu")
        assert len(cands) == 4                        # warps axis only
        assert all(c["tb_pack"] == 1 for c in cands)

    def test_untunable_engines_are_empty(self, linear):
        spec, _ = linear
        assert tune.enumerate_space(spec, "reference", device="cpu") == []
        assert tune.tunable_names("myers") == []
        assert tune.tunable_names("wavefront") == ["strip_warps", "tb_pack"]

    def test_tb_pack_axis_matches_jax(self):
        """The tb_pack values the port keeps for a spec are the ones JAX's
        space keeps for its K1 (the Pallas engine) on the same kernel."""
        from repro import tune as jtune
        from repro.core import kernels_zoo as jzoo
        for kernel in ("global_linear", "global_affine", "global_two_piece"):
            jspec, _ = jzoo.make(kernel)
            spec, _ = pzoo.make(kernel)
            want = {c["tb_pack"]
                    for c in jtune.enumerate_space(jspec, "pallas")}
            got = {c["tb_pack"]
                   for c in tune.enumerate_space(spec, "wavefront",
                                                 device="cpu")}
            assert got == want, kernel


# ---------------------------------------------------------------------------
# cost: rank without launching, default always kept
# ---------------------------------------------------------------------------
class TestCost:
    def test_default_always_kept(self, linear):
        spec, params = linear
        default = tune.default_options(spec, "wavefront", "cpu")
        cands = tune.enumerate_space(spec, "wavefront", (256, 256), "cpu")
        kept, pruned = tune.rank(spec, params, "wavefront", (256, 256), 1024,
                                 cands, default=default, top_k=1)
        assert any(s["options"] == default for s in kept)
        assert len(kept) == 2 and len(kept) + len(pruned) == len(cands) + 1
        assert np.isfinite(kept[-1]["predicted_s"])   # the default, scored

    def test_predictions_are_finite_and_ranked(self, linear):
        spec, params = linear
        cands = tune.enumerate_space(spec, "wavefront", (256, 256), "cpu")
        kept, _ = tune.rank(spec, params, "wavefront", (256, 256), 1024,
                            cands, top_k=len(cands))
        secs = [s["predicted_s"] for s in kept]
        assert all(np.isfinite(t) and t > 0 for t in secs)
        assert secs == sorted(secs)

    def test_model_parts(self):
        """The larger of compute and bytes, plus (G - 1) x STRIP_LAG idle
        wavefronts a pair; one warp a pair has no fill or drain, and a
        packed store moves fewer bytes."""
        spec, _ = pzoo.make(2)
        one = cost.predict(spec, (256, 256), 1024, {"strip_warps": 1,
                                                    "tb_pack": 2})
        eight = cost.predict(spec, (256, 256), 1024, {"strip_warps": 8,
                                                      "tb_pack": 2})
        assert one["fill_s"] == 0 and eight["fill_s"] > 0
        for p in (one, eight):
            assert p["seconds"] == pytest.approx(
                max(p["compute_s"], p["bytes_s"]) + p["fill_s"])
        packed = cost.predict(spec, (256, 256), 1024, {"strip_warps": 4,
                                                       "tb_pack": 2})
        loose = cost.predict(spec, (256, 256), 1024, {"strip_warps": 4,
                                                      "tb_pack": 1})
        assert packed["bytes_s"] < loose["bytes_s"]
        assert cost.predict(spec, (64, 1 << 17), 4, {"strip_warps": 2})[
            "seconds"] == float("inf")          # over the smem limit

    def test_k1_bytes_is_the_bound_chip_smoke_used(self):
        """One copy of K1's byte count: at #2's shapes it equals the
        formula chip_smoke.py's ``time_k1`` has always used."""
        spec, _ = pzoo.make(2)
        B, bq, br, pack, L, C = 1024, 256, 256, 2, 3, 8
        old = (B * bq + B * br + B * (br + 1) * L * 4 + B * (bq + 1) * L * 4
               + B * 8 + B * C * (32 // pack) * (32 + br - 1)
               + 2 * B * C * 32 * 4)
        assert cost.k1_bytes(spec, B, bq, br, pack) == old
        assert cost.MEM_BYTES_PER_S == 3.35e12
        assert cost.PE_OPS[("affine", False)] == 21

    def test_device_model_without_a_card_is_the_stated_h100(self):
        assert cost.device_model("cpu") is cost.H100
        assert cost.device_model(None).sms == 132


# ---------------------------------------------------------------------------
# table: persistence, staleness, env
# ---------------------------------------------------------------------------
class TestTable:
    def test_roundtrip(self, tmp_path):
        t = tune.TuningTable()
        t.record("global_linear", "wavefront", (64, 64), 8,
                 {"strip_warps": 2, "tb_pack": 2}, device="cpu",
                 cells_per_s=1e9)
        path = tmp_path / "t.json"
        t.save(path)
        loaded = tune.TuningTable.load(path)
        assert loaded.lookup_options("global_linear", "wavefront", (64, 64),
                                     8, device="cpu") == \
            {"strip_warps": 2, "tb_pack": 2}
        assert loaded.lookup_options("global_linear", "wavefront", (64, 64),
                                     16, device="cpu") is None

    def test_key_matches_jax_but_for_device_and_version(self):
        from repro import tune as jtune
        got = tune.entry_key("k", "wavefront", (64, 32), 8, device="cpu")
        want = jtune.entry_key("k", "wavefront", (64, 32), 8)
        assert got.split("|")[:4] == want.split("|")[:4]
        assert got.split("|")[4:] == ["cpu", torch.__version__]

    def test_stale_schema_refuses_to_load(self, tmp_path):
        path = tmp_path / "t.json"
        path.write_text(json.dumps({"schema": 999, "entries": {}}))
        with pytest.raises(ValueError, match="schema"):
            tune.TuningTable.load(str(path))

    def test_foreign_torch_version_never_matches(self):
        t = tune.TuningTable()
        key = tune.entry_key("k", "wavefront", (64, 64), 8, device="cpu",
                             torch_version="0.0.0-not-ours")
        t.entries[key] = {"options": {"strip_warps": 4}}
        assert t.lookup_options("k", "wavefront", (64, 64), 8,
                                device="cpu") is None

    def test_foreign_device_never_matches(self):
        t = tune.TuningTable()
        foreign = tune.entry_key("k", "wavefront", (64, 64), 8,
                                 device_name="NVIDIA H100 80GB HBM3")
        t.entries[foreign] = {"options": {"strip_warps": 4}}
        assert t.lookup_options("k", "wavefront", (64, 64), 8,
                                device="cpu") is None
        native = tune.entry_key("k", "wavefront", (64, 64), 8, device="cpu")
        t.entries[native] = {"options": {"strip_warps": 4}}
        assert t.lookup_options("k", "wavefront", (64, 64), 8,
                                device="cpu") == {"strip_warps": 4}

    def test_env_off_disables_installed_table(self, monkeypatch):
        t = tune.TuningTable()
        tune.set_table(t)
        assert tune.active_table() is t
        monkeypatch.setenv(tune.ENV_VAR, "off")
        assert tune.active_table() is None

    def test_env_path_discovery(self, tmp_path, monkeypatch):
        t = tune.TuningTable()
        t.record("global_linear", "wavefront", (32, 32), 4,
                 {"strip_warps": 1}, device="cpu")
        path = tmp_path / "env_table.json"
        t.save(path)
        monkeypatch.setenv(tune.ENV_VAR, str(path))
        assert tune.lookup("global_linear", "wavefront", (32, 32), 4,
                           device="cpu") == {"strip_warps": 1}

    def test_corrupt_table_is_no_table(self, tmp_path, monkeypatch):
        path = tmp_path / "bad.json"
        path.write_text("{not json")
        monkeypatch.setenv(tune.ENV_VAR, str(path))
        assert tune.lookup("k", "wavefront", (32, 32), 4,
                           device="cpu") is None

    def test_jax_table_is_never_read(self):
        from repro import tune as jtune
        assert tune.ENV_VAR != jtune.ENV_VAR
        assert tune.default_path().name == "TUNE_TABLE_TORCH.json"
        assert tune.default_path() != jtune.default_path()


# ---------------------------------------------------------------------------
# the get_plan lookup
# ---------------------------------------------------------------------------
class TestGetPlanConsultsTable:
    def _tuned_table(self):
        t = tune.TuningTable()
        t.record("global_linear", "wavefront", (64, 64), 4,
                 {"strip_warps": 2, "tb_pack": 2}, device="cpu")
        return t

    def _key(self, spec, q=64, **kw):
        return plan_mod.get_plan(spec, "wavefront", (q,), (q,),
                                 batch_size=4, device="cpu", **kw).key

    def test_table_sets_defaults(self, linear):
        spec, _ = linear
        tune.set_table(self._tuned_table())
        plan_mod.clear_plan_cache(keep_stats=True)
        key = self._key(spec)
        assert (key.strip_warps, key.tb_pack) == (2, 2)

    def test_explicit_options_beat_table(self, linear):
        spec, _ = linear
        tune.set_table(self._tuned_table())
        plan_mod.clear_plan_cache(keep_stats=True)
        key = self._key(spec, strip_warps=1)
        # any explicit option opts the whole request out of the table
        assert (key.strip_warps, key.tb_pack) == (1, spec.tb_pack)

    def test_env_off_restores_hand_picked_exactly(self, linear,
                                                  monkeypatch):
        spec, _ = linear
        plan_mod.clear_plan_cache(keep_stats=True)
        baseline = self._key(spec)
        tune.set_table(self._tuned_table())
        monkeypatch.setenv(tune.ENV_VAR, "off")
        plan_mod.clear_plan_cache(keep_stats=True)
        assert self._key(spec) == baseline
        assert (baseline.strip, baseline.strip_warps, baseline.tb_pack,
                baseline.xdrop) == (1, None, spec.tb_pack, None)

    def test_unmatched_point_uses_defaults(self, linear):
        spec, _ = linear
        tune.set_table(self._tuned_table())
        plan_mod.clear_plan_cache(keep_stats=True)
        key = self._key(spec, q=128)
        assert (key.strip_warps, key.tb_pack) == (None, spec.tb_pack)

    def test_device_mismatch_falls_back_to_defaults(self, linear):
        spec, _ = linear
        t = tune.TuningTable()
        key = tune.entry_key("global_linear", "wavefront", (64, 64), 4,
                             device_name="NVIDIA H100 80GB HBM3",
                             torch_version="9.9.9")
        t.entries[key] = {"options": {"strip_warps": 8, "tb_pack": 4}}
        tune.set_table(t)
        plan_mod.clear_plan_cache(keep_stats=True)
        got = self._key(spec)
        assert (got.strip_warps, got.tb_pack) == (None, spec.tb_pack)

    def test_lookups_are_counted_and_traced(self, linear):
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.obs import trace as obs_trace
        spec, _ = linear
        tune.set_table(self._tuned_table())
        plan_mod.clear_plan_cache(keep_stats=True)
        hits = obs_metrics.REGISTRY.counter("plan_tune_lookups_total",
                                            outcome="hit")
        misses = obs_metrics.REGISTRY.counter("plan_tune_lookups_total",
                                              outcome="miss")
        h0, m0 = hits.value, misses.value
        obs_trace.enable()
        try:
            self._key(spec)
            self._key(spec, q=128)
            spans = [s for s in obs_trace.spans()
                     if s.name == "plan.tune_lookup"]
        finally:
            obs_trace.disable()
        assert (hits.value - h0, misses.value - m0) == (1, 1)
        assert len(spans) >= 2


# ---------------------------------------------------------------------------
# option validators (errors name the option)
# ---------------------------------------------------------------------------
class TestValidators:
    @pytest.mark.parametrize("req,name", [
        ({"strip": 0}, "strip"),
        ({"strip": 1.5}, "strip"),
        ({"strip": True}, "strip"),
        ({"strip": "4"}, "strip"),
        ({"xdrop": -1}, "xdrop"),
        ({"xdrop": 2.5}, "xdrop"),
        ({"tb_pack": 1.0}, "tb_pack"),
        ({"strip_warps": 0}, "strip_warps"),
        ({"strip_warps": 1.5}, "strip_warps"),
        ({"strip_warps": True}, "strip_warps"),
    ])
    def test_bad_values_name_the_option(self, linear, req, name):
        spec, _ = linear
        with pytest.raises(ValueError, match=name):
            plan_mod.resolve_engine_options(spec, "wavefront", req, "cpu")

    def test_pow2_validator(self):
        assert plan_mod.validate_pow2_option("screen_block", 64) == 64
        with pytest.raises(ValueError, match="screen_block"):
            plan_mod.validate_pow2_option("screen_block", 48)
        with pytest.raises(ValueError, match="screen_block"):
            plan_mod.validate_pow2_option("screen_block", 0)

    @pytest.mark.parametrize("warps", [0, 3, 9])
    def test_k1_refuses_warps_out_of_range(self, linear, warps):
        """K1's wrapper raises, naming the option, for warps outside [1,
        min(8, Q/32)]; the plain version runs every legal count to the
        same bits."""
        spec, params = linear
        data = tune.make_batch(np.random.default_rng(0), spec, (64, 64), 2,
                               "cpu")
        kw = dict(q_lens=data[2], r_lens=data[3])
        if warps == 3:          # legal range at Q=64 is [1, 2]
            with pytest.raises(ValueError, match="strip_warps"):
                k1_ops.run(spec, params, data[0], data[1], strip_warps=3,
                           **kw)
            base = k1_ops.run(spec, params, data[0], data[1], **kw)
            for w in (1, 2):
                got = k1_ops.run(spec, params, data[0], data[1],
                                 strip_warps=w, **kw)
                tune.assert_parity(spec, base, got)
            return
        with pytest.raises(ValueError, match="strip_warps"):
            k1_ops.run(spec, params, data[0], data[1], strip_warps=warps,
                       **kw)

    def test_warps_range(self):
        assert K1.warps_range(32) == (1, 1)
        assert K1.warps_range(64) == (1, 2)
        assert K1.warps_range(1024) == (1, 8)


# ---------------------------------------------------------------------------
# cache stats history (clear_plan_cache keep_stats)
# ---------------------------------------------------------------------------
class TestCacheStatsHistory:
    def test_keep_stats_rolls_totals(self, linear):
        spec, params = linear
        plan_mod.clear_plan_cache()
        plan = plan_mod.get_plan(spec, "wavefront", (16,), (16,),
                                 batch_size=2, with_traceback=False,
                                 mode="fill", device="cpu")
        plan(params, *tune.make_batch(np.random.default_rng(0), spec,
                                      (16, 16), 2, "cpu"))
        before = plan_mod.plan_cache_info()["totals"]
        assert before["compiled"] == 1 and before["compile_s"] > 0
        plan_mod.clear_plan_cache(keep_stats=True)
        after = plan_mod.plan_cache_info()["totals"]
        assert after["plans"] == before["plans"]
        assert after["compiled"] == 1
        assert after["compile_s"] == pytest.approx(before["compile_s"])
        assert plan_mod.plan_cache_info()["size"] == 0
        plan_mod.clear_plan_cache()
        assert plan_mod.plan_cache_info()["totals"]["compiled"] == 0


# ---------------------------------------------------------------------------
# search: parity gate, winner >= default, sweep -> table
# ---------------------------------------------------------------------------
class TestSearch:
    @pytest.mark.parametrize("mode", ["fill", "align"])
    def test_tune_point_measures_default_and_wins(self, linear, mode,
                                                  monkeypatch):
        monkeypatch.setenv(tune.ENV_VAR, "off")
        spec, params = linear
        res = tune.tune_point(spec, params, "wavefront", (64, 64), 2,
                              top_k=2, iters=1, mode=mode, device="cpu")
        assert res["speedup_vs_default"] >= 1.0
        measured = [m["options"] for m in res["measurements"]]
        assert res["default_options"] in measured
        assert res["options"] in measured
        assert len(measured) == 3           # top 2 + the default

    def test_tune_point_nothing_to_tune(self):
        spec, params = pzoo.make("edit_distance")
        assert tune.tune_point(spec, params, "myers", (32, 32), 2,
                               device="cpu") is None

    def test_parity_catches_score_mismatch(self, linear):
        spec, _ = linear
        from repro_torch.core.types import Alignment
        a = Alignment(score=torch.tensor([1]), end_i=torch.tensor([1]),
                      end_j=torch.tensor([1]))
        b = Alignment(score=torch.tensor([2]), end_i=torch.tensor([1]),
                      end_j=torch.tensor([1]))
        tune.assert_parity(spec, a, a)
        with pytest.raises(AssertionError):
            tune.assert_parity(spec, a, b)

    def test_parity_compares_fills_unpacked(self, linear):
        """Fills at two tb_pack values hold the same pointers in different
        bytes: the gate compares them unpacked, and still catches one
        flipped pointer."""
        spec, params = linear
        data = tune.make_batch(np.random.default_rng(1), spec, (64, 64), 2,
                               "cpu")
        kw = dict(q_lens=data[2], r_lens=data[3])
        one = k1_ops.run(spec, params, data[0], data[1], tb_pack=1, **kw)
        four = k1_ops.run(spec, params, data[0], data[1], tb_pack=4, **kw)
        tune.assert_parity(spec, one, four)
        bad = one.tb.clone()
        bad[0, 0, 5, 10] ^= 1
        from dataclasses import replace
        with pytest.raises(AssertionError):
            tune.assert_parity(spec, replace(one, tb=bad), four)

    def test_a_candidate_that_differs_fails_the_gate(self, linear,
                                                     monkeypatch):
        """A schedule that changed results would never be timed: the sweep
        stops at the parity gate."""
        monkeypatch.setenv(tune.ENV_VAR, "off")
        spec, params = linear
        real = k1_ops.run

        def off_by_one(*a, strip_warps=None, **k):
            res = real(*a, strip_warps=strip_warps, **k)
            if strip_warps == 1:
                res.score = res.score + 1
            return res
        monkeypatch.setattr(k1_ops, "run", off_by_one)
        plan_mod.clear_plan_cache()
        with pytest.raises(AssertionError, match="strip_warps': 1"):
            tune.tune_point(spec, params, "wavefront", (64, 64), 2,
                            top_k=8, iters=1, mode="fill", device="cpu")
        plan_mod.clear_plan_cache()

    def test_run_sweep_records_and_skips(self, monkeypatch):
        monkeypatch.setenv(tune.ENV_VAR, "off")
        points = [("global_linear", "wavefront", (32, 32), 2),
                  ("edit_distance", "myers", (32, 32), 2)]   # untunable
        table = tune.run_sweep(points, top_k=2, iters=1, device="cpu",
                               mode="fill")
        assert len(table) == 1
        opts = table.lookup_options("global_linear", "wavefront", (32, 32),
                                    2, device="cpu")
        assert set(opts) == {"strip_warps", "tb_pack"}

    def test_cli_writes_a_table(self, tmp_path, capsys):
        from repro_torch.tune.__main__ import main
        out = tmp_path / "t.json"
        rc = main(["--kernels", "global_linear", "--buckets", "32",
                   "--batches", "2", "--device", "cpu", "--iters", "1",
                   "--out", str(out), "--fresh"])
        assert rc == 0 and "wrote" in capsys.readouterr().out
        assert len(tune.TuningTable.load(out)) == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _tune_case(name):
    if name == "pairhmm":
        from repro_torch import prob
        return prob.cached_pairhmm(), prob.default_params()
    return pzoo.make(name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["global_affine", "local_affine",
                                  "pairhmm"])
def test_cuda_every_warps_count_gives_the_same_bits(name):
    """K1 on the card at every legal ``strip_warps`` and ``tb_pack`` gives
    the heuristic's result bit for bit (pointers compared unpacked), and
    ``tune_point`` passes its parity gate there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is CUDA C++ with no CPU mode)")
    spec, params = _tune_case(name)
    for B, Q, R in [(8, 256, 256), (3, 1024, 1024)]:
        q, r, ql, rl = tune.make_batch(np.random.default_rng(B), spec, (Q, R),
                                       B, "cuda")
        ql, rl = ql.cuda(), rl.cuda()
        base = k1_ops.run(spec, params, q, r, ql, rl)
        for cand in tune.enumerate_space(spec, "wavefront", (Q, R), "cuda"):
            got = k1_ops.run(spec, params, q, r, ql, rl, **cand)
            tune.assert_parity(spec, base, got, ctx=f"{name} {Q}x{R} {cand}")
    res = tune.tune_point(spec, params, "wavefront", (256, 256), 64,
                          mode="fill", iters=1, device="cuda")
    assert res["speedup_vs_default"] >= 1.0
