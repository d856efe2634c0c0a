"""The port's alignment launcher against the JAX package's, on the CPU:
``data.synthetic.genomics_pairs`` (the same arrays from the same seed),
``launch.serve.serve_alignments`` (the drained results request for request
against JAX's ``serve_alignments`` on the same pairs: on JAX's own
``wavefront`` engine for #2, a corner-region kernel where the two engines'
tie-break rules agree, and on a service over JAX's ``reference`` engine
for a local kernel, as ``tests/test_torch_gateway.py`` holds the service),
and ``python -m repro_torch.launch.serve --mode align``."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.data import genomics_pairs
from repro_torch.launch import serve as pserve
from repro_torch.serve import alignment_service as psvc

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n,length", [(32, 128), (5, 40)])
def test_genomics_pairs_equal_jax(seed, n, length):
    from repro.data import genomics_pairs as jpairs
    got, want = genomics_pairs(n, length, seed=seed), jpairs(n, length,
                                                             seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _drained(monkeypatch, cls, run):
    """Run ``run()`` and return the requests each service it builds was
    given, in submission order (the launchers return only the service)."""
    seen = []
    submit = cls.submit

    def record(self, req):
        seen.append(req)
        return submit(self, req)
    monkeypatch.setattr(cls, "submit", record)
    run()
    monkeypatch.setattr(cls, "submit", submit)
    return [r.result for r in seen]


def test_serve_alignments_equal_jax(monkeypatch):
    """JAX's launcher at its defaults (32 pairs of 128, #2, its default
    ``wavefront`` engine) and the port's on the CPU: score, end cell and
    CIGAR of every request equal."""
    from repro.launch import serve as jserve
    from repro.serve import alignment_service as jsvc
    want = _drained(monkeypatch, jsvc.AlignmentService,
                    jserve.serve_alignments)
    got = _drained(monkeypatch, psvc.AlignmentService,
                   lambda: pserve.serve_alignments(device="cpu"))
    assert len(got) == len(want) == 32
    for rid, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"request {rid}: port {g} != JAX {w}"
        assert "cigar" in g


def test_serve_alignments_local_kernel_equal_jax_reference(monkeypatch):
    """A local kernel (#4, whose end cell can tie): the port's launcher
    against JAX's service on its ``reference`` engine over the launcher's
    pairs, request for request."""
    from repro.data import genomics_pairs as jpairs
    from repro.serve import AlignRequest as JRequest
    from repro.serve import AlignmentService as JService
    qs, rs, ql, rl = jpairs(12, 64, seed=3)
    svc = JService(max_len=64, block=8, engine_name="reference")
    reqs = [JRequest(rid=i, kernel="local_affine", query=qs[i, : ql[i]],
                     ref=rs[i, : rl[i]]) for i in range(12)]
    for r in reqs:
        svc.submit(r)
    svc.drain()
    got = _drained(monkeypatch, psvc.AlignmentService,
                   lambda: pserve.serve_alignments(
                       "local_affine", n=12, length=64, seed=3,
                       device="cpu"))
    for rid, (g, w) in enumerate(zip(got, [r.result for r in reqs])):
        assert g == w, f"request {rid}: port {g} != JAX {w}"


def test_main_align_mode_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--mode", "align", "--device", "cpu"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == \
        "alignment service drained OK"
