"""A kernel of the port's zoo (``repro_torch.core.kernels_zoo``) with the
configuration's integer scoring, as a user of the library builds it."""
from __future__ import annotations


def make(program: dict):
    from repro_torch.core import kernels_zoo
    spec, params = kernels_zoo.make(program["kernel"])
    params = dict(params)
    params.update({k: int(v) for k, v in program["params"].items()})
    return spec, params
