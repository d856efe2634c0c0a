"""repro_torch.mapping — seed-and-extend read mapping on the port's runtime
(counterpart of ``repro.mapping``): minimizer indexing (``index``), batched
seeding (``seed``), anchor chaining (``chain``), the bit-parallel screen on
kernel K2 and banded extension on kernel K1 (``extend``), and SAM-like
emission (``sam``), behind the ``ReadMapper`` facade (``pipeline``).
"""
from .index import MinimizerIndex, build_index, kmer_hashes, minimizers
from .seed import seed_anchors, top_anchors
from .chain import ChainResult, chain_anchors
from .extend import ExtendJob, extend_jobs, extension_spec, make_job
from .sam import (FLAG_REVERSE, FLAG_UNMAPPED, SAM_OPS, SamRecord,
                  cigar_spans, moves_to_sam_cigar, sam_header)
from .pipeline import ReadMapper, mapq_from_chains

__all__ = [
    "MinimizerIndex", "build_index", "kmer_hashes", "minimizers",
    "seed_anchors", "top_anchors",
    "ChainResult", "chain_anchors",
    "ExtendJob", "extend_jobs", "extension_spec", "make_job",
    "FLAG_REVERSE", "FLAG_UNMAPPED", "SAM_OPS", "SamRecord",
    "cigar_spans", "moves_to_sam_cigar", "sam_header",
    "ReadMapper", "mapq_from_chains",
]
