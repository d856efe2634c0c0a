"""The port's pair-HMM forward (``repro_torch.prob.kernels``): the shared
spec object of the configuration's objective and the parameter dict
``default_params`` makes from its probabilities."""
from __future__ import annotations


def make(program: dict):
    from repro_torch.prob import kernels
    spec = kernels.cached_pairhmm(program["objective"])
    p = program["params"]
    params = kernels.default_params(delta=float(p["delta"]),
                                    eps=float(p["eps"]),
                                    match_p=float(p["match_p"]))
    return spec, params
