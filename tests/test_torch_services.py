"""The port's genotyping and read-mapping services against the JAX
package's, on the CPU: genotype calls equal and likelihoods within rtol
2e-5 of JAX's ``GenotypingService`` (the pair-HMM tolerance of
``tests/test_prob.py``), and SAM text equal to JAX's
``ReadMappingService``, on the same seeded sites and reads."""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import alphabets as jalphabets
from repro.data.synthetic import sample_reads as jsample_reads
from repro.serve import GenotypeRequest as JGenotypeRequest
from repro.serve import GenotypingService as JGenotypingService
from repro.serve import MapRequest as JMapRequest
from repro.serve import ReadMappingService as JReadMappingService
from repro_torch import prob
from repro_torch.data.synthetic import sample_reads, sample_site
from repro_torch.serve import (FaultPlan, GenotypeRequest,
                               GenotypingService, InjectedFault, MapRequest,
                               ReadMappingService, ServiceOverloaded)

RTOL = 2e-5


def _sites(n=6):
    cycle = [(0, 0), (0, 1), (1, 1)]
    return [sample_site(seed=40 + k, hap_len=48, read_len=24, n_reads=6,
                        error_rate=0.02, genotype=(1, 2) if k == 5
                        else cycle[k % 3], n_alts=2 if k == 5 else 1)
            for k in range(n)]


def _genotype(service, request, sites, serve=False, **kw):
    svc = service(**kw)
    futs = [svc.submit(request(rid=k, reads=s.reads,
                               haplotypes=s.haplotypes))
            for k, s in enumerate(sites)]
    if serve:
        svc.serve(n_workers=2, timeout_s=120.0)
    else:
        svc.drain()
    return [f.result() for f in futs], svc


def _same_call(got, want):
    assert got["GT"] == want["GT"]
    assert got["GQ"] == want["GQ"] and got["PL"] == want["PL"]
    assert got["genotypes"] == want["genotypes"]
    np.testing.assert_allclose(got["ll"], want["ll"], rtol=RTOL)
    np.testing.assert_allclose(got["gl"], want["gl"], rtol=RTOL)


@pytest.fixture(scope="module")
def jax_calls():
    calls, _ = _genotype(JGenotypingService, JGenotypeRequest, _sites(),
                         max_len=64, block=8)
    return calls


@pytest.mark.parametrize("mode", ["drain", "serve", "sync", "hap_norm_off"])
def test_genotype_calls_equal_jax(mode, jax_calls):
    sites = _sites()
    kw = dict(max_len=64, block=8, device="cpu")
    if mode == "sync":
        kw["pipeline_depth"] = 1
    if mode == "hap_norm_off":
        kw["hap_norm"] = False
    got, svc = _genotype(GenotypingService, GenotypeRequest, sites,
                         serve=mode == "serve", **kw)
    want = jax_calls
    if mode == "hap_norm_off":
        want, _ = _genotype(JGenotypingService, JGenotypeRequest, sites,
                            max_len=64, block=8, hap_norm=False)
    for g, w in zip(got, want):
        _same_call(g, w)
    assert [g["GT"] for g in got[:5]] == \
        [tuple(s.genotype) for s in sites[:5]]
    assert svc.metrics()["reconcile"]["ok"]
    assert svc._pending == 0


def test_genotype_call_equals_call_site(jax_calls):
    """The service's call of a site is ``prob.call_site``'s (the direct
    path chip_smoke.py holds the card's service to)."""
    sites = _sites(3)
    got, _ = _genotype(GenotypingService, GenotypeRequest, sites,
                       max_len=64, block=8, device="cpu")
    for s, g in zip(sites, got):
        direct = prob.call_site(s.reads, s.haplotypes, block=8,
                                device="cpu")
        assert g["GT"] == direct["GT"] and g["PL"] == direct["PL"]
        np.testing.assert_allclose(g["ll"], direct["ll"], rtol=RTOL)


def test_genotyping_service_warm_and_faults(jax_calls):
    from repro_torch.runtime import plan as plan_mod
    plan_mod.clear_plan_cache()
    sites = _sites()
    svc = GenotypingService(max_len=64, block=8, max_retries=8,
                            fault_plan=FaultPlan(seed=3, fail_launch_p=0.3,
                                                 fail_harvest_p=0.2),
                            warm_start=[(24, 48), (40, 48)], device="cpu")
    assert plan_mod.plan_cache_info()["totals"]["compiled"] == 2
    futs = [svc.submit(GenotypeRequest(rid=k, reads=s.reads,
                                       haplotypes=s.haplotypes))
            for k, s in enumerate(sites)]
    while not all(f.done() for f in futs):
        try:
            svc.drain()
        except InjectedFault:
            pass
    assert svc.stats["faults"] > 0 and not svc.dead_letters
    for f, w in zip(futs, jax_calls):
        _same_call(f.result(), w)
    assert svc.metrics()["reconcile"]["ok"]
    plan_mod.clear_plan_cache()


def test_genotyping_service_validates_and_backpressure():
    svc = GenotypingService(max_len=32, device="cpu")
    with pytest.raises(ValueError, match="length"):
        svc.submit(GenotypeRequest(rid=0, reads=[np.zeros(64, np.uint8)],
                                   haplotypes=[np.zeros(16, np.uint8)]))
    with pytest.raises(ValueError, match="read"):
        svc.submit(GenotypeRequest(rid=1, reads=[],
                                   haplotypes=[np.zeros(16, np.uint8)]))
    with pytest.raises(ValueError, match="ploidy"):
        svc.submit(GenotypeRequest(rid=2, reads=[np.ones(8, np.uint8)],
                                   haplotypes=[np.ones(8, np.uint8)],
                                   ploidy=0))
    assert svc._pending == 0
    site = _sites(1)[0]
    svc = GenotypingService(max_len=64, max_pending=1, backpressure="raise",
                            device="cpu")
    svc.submit(GenotypeRequest(0, site.reads, site.haplotypes))
    with pytest.raises(ServiceOverloaded):
        svc.submit(GenotypeRequest(1, site.reads, site.haplotypes))
    svc.drain()
    svc.submit(GenotypeRequest(2, site.reads, site.haplotypes))


# -- read mapping ------------------------------------------------------------
def _map_inputs():
    rng = np.random.default_rng(11)
    ref = jalphabets.random_dna(rng, 6000)
    rs = sample_reads(ref, 10, 100, error_rate=0.05, seed=11)
    jrs = jsample_reads(ref, 10, 100, error_rate=0.05, seed=11)
    np.testing.assert_array_equal(rs.reads, jrs.reads)
    reads = [rs.reads[i, : rs.lens[i]] for i in range(10)]
    reads.append(jalphabets.random_dna(rng, 100))       # junk: unmapped
    return ref, rs, reads


def _map(service, request, ref, reads, **kw):
    svc = service(ref, block=4, **kw)
    reqs = [request(rid=i, read=r) for i, r in enumerate(reads)]
    for r in reqs:
        svc.submit(r)
    assert svc.drain() == len(reqs)
    return [r.result for r in reqs], list(svc.dispatches), svc


@pytest.fixture(scope="module")
def jax_mapped():
    ref, _, reads = _map_inputs()
    return _map(JReadMappingService, JMapRequest, ref, reads, max_batch=4)


@pytest.mark.parametrize("max_batch", [4, None])
def test_mapping_service_sam_equal_jax(max_batch, jax_mapped):
    ref, rs, reads = _map_inputs()
    got, gd, svc = _map(ReadMappingService, MapRequest, ref, reads,
                        max_batch=max_batch, device="cpu")
    want, wd, _ = jax_mapped
    for g, w in zip(got, want):
        assert g == w
    assert [d["n"] for d in gd] == ([4, 4, 3] if max_batch else [11])
    assert [d["n"] for d in wd] == [4, 4, 3]
    for i in range(10):
        assert got[i]["mapped"]
        assert abs((got[i]["pos"] - 1) - int(rs.pos[i])) <= 5
        assert got[i]["sam"].startswith(f"r{i}\t")
    assert not got[10]["mapped"]
    # the records are the mapper's own on the same reads
    direct = svc.mapper.map_reads(reads, names=[f"r{i}" for i in
                                                range(len(reads))])
    assert [g["sam"] for g in got] == [d.to_line() for d in direct]


def test_mapping_service_requeues_in_order_and_warms(jax_mapped,
                                                    monkeypatch):
    from repro_torch.runtime import plan as plan_mod
    ref, _, reads = _map_inputs()
    svc = ReadMappingService(ref, block=4, max_batch=4, device="cpu")
    plan_mod.clear_plan_cache()
    assert svc.warm([(100, 200, 32)]) == 2
    keys = {plan_mod.plan_key_str(k)
            for k in plan_mod.plan_cache_info()["keys"]}
    assert "edit_search/myers/128x256/b64/notb/align/p1/minplus/cpu" in keys
    reqs = [MapRequest(rid=i, read=r) for i, r in enumerate(reads)]
    for r in reqs:
        svc.submit(r)
    real = svc.mapper.map_reads
    boom = {"armed": True}

    def exploding(reads, lens=None, names=None):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected mapper failure")
        return real(reads, lens, names)

    monkeypatch.setattr(svc.mapper, "map_reads", exploding)
    with pytest.raises(RuntimeError, match="injected"):
        svc.drain()
    assert svc.queue == reqs                  # nothing lost, order kept
    assert svc.drain() == len(reqs)
    want, _, _ = jax_mapped
    assert [r.result for r in reqs] == want
    plan_mod.clear_plan_cache()
