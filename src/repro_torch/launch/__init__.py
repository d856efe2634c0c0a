"""Launchers of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` and the dry run,
``python -m repro_torch.launch.dryrun``; the device meshes (``mesh``), the
sharding context (``shardctx``), the per-cell specs (``specs``), the
counter of a program's cost (``hlo_cost``) and the roofline that reads it
(``roofline``).  Importing this package touches no device or process
group."""
from . import hlo_cost, roofline  # noqa: F401
from .mesh import make_host_mesh, make_production_mesh  # noqa: F401
from .shardctx import NullCtx, ShardCtx  # noqa: F401
