"""Launchers of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``, the device meshes (``mesh``) and the
sharding context (``shardctx``).  JAX's launch package also exports the dry
run's HLO cost and roofline readers; those wait for ROADMAP item 15g."""
