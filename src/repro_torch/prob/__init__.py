"""repro_torch.prob: the probabilistic (sum-semiring) DP subsystem of the
port (counterpart of ``repro.prob``): pair-HMM kernels (``kernels``),
forward-backward posterior decoding (``posterior``) and pair-HMM genotyping
over the batched runtime (``genotype``)."""
from repro_torch.core.semiring import (LOG_SUM_EXP, MAX_PLUS, MIN_PLUS,
                                       Semiring, from_objective)

from .kernels import (cached_pairhmm, cached_pairhmm_backward,
                      default_params, pairhmm, pairhmm_backward)
from .oracle import oracle_forward
from .posterior import PosteriorResult, forward_backward
from .genotype import (call_genotype, call_site, genotype_log_likelihoods,
                       genotypes, read_hap_log_likelihoods)

__all__ = [
    "LOG_SUM_EXP", "MAX_PLUS", "MIN_PLUS", "Semiring", "from_objective",
    "cached_pairhmm", "cached_pairhmm_backward", "default_params",
    "pairhmm", "pairhmm_backward",
    "PosteriorResult", "forward_backward", "oracle_forward",
    "call_genotype", "call_site", "genotype_log_likelihoods",
    "genotypes", "read_hap_log_likelihoods",
]
