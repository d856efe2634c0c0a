"""The harness on the CPU at tiny sizes: traffic made from the seed, the
result line, the import check, discovery of new cells by name, the
timeline's reduction, and one run on the card (gpu marker)."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bench import floor, harness, trace, traffic

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TINY = {
    "short_b262144": {"batch": 8, "bucket": [64, 64], "read_max": 64,
                      "window": {"dist": "uniform", "lo": 32, "hi": 64},
                      "pool_blocks": 2, "check_pairs": 0,
                      "genome_bases": 4096},
    "sites_b32768": {"batch": 12, "bucket": [32, 64], "read_len": [10, 20],
                     "hap_len": [40, 60], "reads_per_site": 3,
                     "pool_blocks": 2, "check_pairs": 0},
}
CELLS = {"short_b262144": "sw_affine_dna.short_b262144",
         "sites_b32768": "pairhmm_hc.sites_b32768"}
BIG_SEED = 2 ** 40 + 3


def _traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def tiny_cell(name):
    cell = harness.resolve(harness.load_benchmark(ROOT), CELLS[name])
    cell.traffic.update(TINY[name])
    return cell


@pytest.mark.parametrize("name", ["short_b262144", "mixed_b262144",
                                  "long_b1024", "sites_b32768"])
def test_traffic_is_deterministic_and_fixed_in_size(name):
    t = _traffic(name)
    # a cut pool of the cell's own shapes: two blocks
    t["pool_blocks"] = 2
    if t["kind"] == "windows":
        t["batch"] = min(t["batch"], 256)
    a = traffic.make_pool(t, BIG_SEED)
    b = traffic.make_pool(t, BIG_SEED)
    c = traffic.make_pool(t, 17)
    for x, y in zip(a, b):
        for f in ("queries", "refs", "q_lens", "r_lens"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert not all(np.array_equal(x.refs, y.refs) for x, y in zip(a, c))
    Q, R = t["bucket"]
    for blk in a + c:
        assert blk.queries.shape == (t["batch"], Q)
        assert blk.refs.shape == (t["batch"], R)
        assert 1 <= blk.q_lens.min() and blk.q_lens.max() <= Q
        assert 1 <= blk.r_lens.min() and blk.r_lens.max() <= R
    # every seed gets the same sizes of reference windows or haplotypes
    ra = np.sort(np.concatenate([x.r_lens for x in a]))
    rc = np.sort(np.concatenate([x.r_lens for x in c]))
    np.testing.assert_array_equal(ra, rc)


def test_check_sample_is_drawn_from_the_seed():
    t = dict(_traffic("short_b262144"), batch=64, pool_blocks=3,
             check_pairs=50)
    pool = traffic.make_pool(t, 5)
    a = traffic.check_sample(t, pool, BIG_SEED)
    b = traffic.check_sample(t, pool, BIG_SEED)
    c = traffic.check_sample(t, pool, 6)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0] * 64 + a[1], c[0] * 64 + c[1])
    assert a[0].shape == (50,) and a[1].max() < 64 and a[0].max() < 3


def test_mutate_edits_at_the_rate():
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 4, 200_000).astype(np.uint8)
    out, lens = traffic.mutate(np.random.default_rng(1), seq,
                               np.array([100_000, 100_000]), 0.08)
    assert lens.sum() == out.shape[0]
    # deletions and insertions balance: the length stays within 1 %
    assert abs(lens.sum() - 200_000) < 2_000
    assert out.max() < 4


@pytest.mark.parametrize("name", sorted(CELLS))
def test_result_line_keys(name):
    res = harness.run_cell(tiny_cell(name), BIG_SEED, 0.3, device="cpu",
                           log=lambda *a: None)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"gcups", "setup_s"}
    assert res["metrics"]["gcups"]["unit"] == "Gcells/s"
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(res)


def test_traced_line_has_the_per_layer_metrics_and_a_breakdown():
    res = harness.run_cell(tiny_cell("short_b262144"), 3, 0.3, trace=True,
                           device="cpu", log=lambda *a: None)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    # no device on the CPU: only the host's span reads anything
    assert set(res["metrics"]) == {"host_submit_ms"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"repro_torch": 0, "repro_torch.core": 0, "jaxtyping": 0,
            "reprolib": 0, "numpy": 0}
    assert harness.forbidden_modules(mods) == []
    mods.update({"repro": 0, "repro.core.api": 0, "jax.numpy": 0,
                 "jaxlib": 0, "flax.linen": 0})
    assert harness.forbidden_modules(mods) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core.api"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    banned = set(harness.FORBIDDEN) | {"benchmarks", "chip_smoke"}
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in banned, (path, name)
    # the references read only the configuration and the codes
    for path in (BENCH / "reference").glob("*.py"):
        assert all(n.split(".")[0] != "repro_torch"
                   for n in _imports(path)), path


def test_a_run_loads_no_jax():
    code = ("import sys\n"
            "sys.path[:0] = ['src', '.']\n"
            "from bench.tests.test_bench_harness import tiny_cell\n"
            "from bench import harness\n"
            "harness.run_cell(tiny_cell('short_b262144'), 1, 0.2,\n"
            "                 device='cpu', log=lambda *a: None)\n"
            "assert not harness.forbidden_modules(), "
            "harness.forbidden_modules()\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]


def test_run_refuses_without_a_card():
    done = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         CELLS["short_b262144"], "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert done.returncode != 0
    assert done.stdout.strip() == ""


def test_new_cell_found_by_name(tmp_path):
    """A traffic mix (with a traffic kind and an entry of its own), a
    configuration and a per-layer metric added as new files, with new
    BENCHMARK.json entries, run with no file edited."""
    bench_dir = tmp_path / "bench"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    tiny = dict(_traffic("short_b262144"), **TINY["short_b262144"])
    (bench_dir / "traffic" / "tiny_tb.json").write_text(
        json.dumps(dict(tiny, with_traceback=True, kind="reversed_windows",
                        entry="counted")))
    (bench_dir / "traffic_kinds" / "reversed_windows.py").write_text(
        "from bench import traffic\n"
        "from bench.traffic_kinds import windows\n"
        "def make(t, rng):\n"
        "    return [traffic.Block(b.queries[::-1].copy(),\n"
        "                          b.refs[::-1].copy(),\n"
        "                          b.q_lens[::-1].copy(),\n"
        "                          b.r_lens[::-1].copy())\n"
        "            for b in windows.make(t, rng)]\n")
    (bench_dir / "entries" / "counted.py").write_text(
        "from bench.entries import align_batch\n"
        "def make(cell, blocks, dev, call=None):\n"
        "    c = align_batch.make(cell, blocks, dev, call)\n"
        "    submit, seen = c.submit, cell.traffic.setdefault('seen', [])\n"
        "    c.submit = lambda k: seen.append(k) or submit(k)\n"
        "    return c\n")
    cfg = json.loads((BENCH / "configs" / "sw_affine_dna.json").read_text())
    cfg["name"] = "sw_bwa_linear_like"
    cfg["program"]["params"]["gap_open"] = -5
    (bench_dir / "configs" / "sw_other.json").write_text(json.dumps(cfg))
    (bench_dir / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return run.calls / run.window_s\n")
    bench = harness.load_benchmark(ROOT)
    bench["configs"].append({"name": "sw_other", "source": "x",
                             "file": "bench/configs/sw_other.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "sw_other.tiny_tb",
                               "config": "sw_other", "traffic": "tiny_tb",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "gcups",
                               "workloads": ["sw_other.tiny_tb"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve(harness.load_benchmark(tmp_path),
                           "sw_other.tiny_tb", bench_dir)
    assert cell.config["program"]["params"]["gap_open"] == -5
    res = harness.run_cell(cell, 9, 0.3, trace=True, device="cpu",
                           log=lambda *a: None)
    assert res["correct"] is True
    assert "calls_per_s" in res["metrics"]
    assert "tb_bad_paths" in res["checks"]
    # the window ran through the new entry
    assert len(cell.traffic["seen"]) > 2


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_timeline_busy_idle_and_breakdown():
    ev = [_event(trace.WINDOW, "user_annotation", 0, 100),
          _event(trace.SUBMIT, "user_annotation", 0, 30),
          _event("aten::copy_", "cpu_op", 5, 20),
          _event(trace.HARVEST, "user_annotation", 60, 40),
          _event("void wavefront_kernel<A>(KArgs)", "kernel", 30, 20),
          _event("void wavefront_kernel<A>(KArgs)", "kernel", 40, 20),
          _event("Memcpy HtoD", "gpu_memcpy", 70, 10),
          # outside the window: clipped away
          _event("void other_kernel()", "kernel", 150, 10)]
    tl = trace.from_events(ev)
    assert tl.window_s == pytest.approx(100e-6)
    assert tl.busy_s == pytest.approx(40e-6)      # [30, 60] and [70, 80]
    assert tl.device_seconds("wavefront_kernel") == pytest.approx(40e-6)
    bd = tl.breakdown()
    assert bd["device_ops"][0] == ["void wavefront_kernel<A>(KArgs)",
                                   pytest.approx(40e-6)]
    # the gaps [0, 30], [80, 100] and [60, 70], longest first
    assert [g[1] for g in bd["idle_gaps"]] == pytest.approx(
        [30e-6, 20e-6, 10e-6])
    assert bd["idle_gaps"][0][0] == f"{trace.SUBMIT}/aten::copy_"
    assert bd["idle_gaps"][1][0] == trace.HARVEST


def test_host_submit_ms_leaves_out_the_waits_for_the_card():
    ev = [_event(trace.WINDOW, "user_annotation", 0, 1000),
          _event(trace.SUBMIT, "user_annotation", 0, 400),
          _event("cudaMemcpyAsync", "cuda_runtime", 10, 5),
          _event("cudaStreamSynchronize", "cuda_runtime", 15, 300),
          _event("cudaLaunchKernel", "cuda_runtime", 350, 10),
          _event(trace.HARVEST, "user_annotation", 400, 200),
          _event("cudaEventSynchronize", "cuda_runtime", 410, 150),
          _event(trace.SUBMIT, "user_annotation", 600, 200),
          _event("cudaStreamSynchronize", "cuda_runtime", 610, 50)]
    run = harness.Run({}, {}, setup_s=1.0, trace=trace.from_events(ev))
    got = harness.load_module("metrics", "host_submit_ms").read(run)
    # (400 - 300) and (200 - 50) microseconds: the harvest's wait is not
    # the entry's
    assert got == pytest.approx((100 + 150) / 2 / 1e3)
    run.trace = None
    assert harness.load_module("metrics", "host_submit_ms").read(run) \
        is None


def test_k1_roofline_reads_the_frozen_floor():
    cfg = json.loads((BENCH / "configs" / "sw_affine_dna.json").read_text())
    tl = trace.Timeline(window_s=1.0, busy_s=0.9,
                        device=[("wavefront_kernel<x>", 0.0, 1e6)],
                        gaps=[], host=[], cells=10 ** 12, bases=10 ** 6,
                        pairs=10)
    run = harness.Run(cfg, {}, setup_s=1.0, trace=tl)
    got = harness.load_module("metrics", "k1_roofline").read(run)
    want = 100 * 10 ** 12 * 6.5 / 2 / floor.LANE_ISSUES_PER_S
    assert got == pytest.approx(want)
    idle = harness.load_module("metrics", "device_idle_share").read(run)
    assert idle == pytest.approx(10.0)
    run.trace = None
    assert harness.load_module("metrics", "k1_roofline").read(run) is None


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CELLS))
def test_tiny_cell_on_the_card(card, name):
    res = harness.run_cell(tiny_cell(name), 21, 0.5, trace=True,
                           device="cuda", log=lambda *a: None)
    assert res["correct"] is True
    assert 0 < res["metrics"]["k1_roofline"]["value"] <= 100
    assert 0 <= res["metrics"]["device_idle_share"]["value"] < 100
