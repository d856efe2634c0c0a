"""Launchers of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``.  JAX's launch package also exports
the mesh builders, the sharding context and the dry run's HLO cost and
roofline readers; those wait for multi-GPU placement (ROADMAP queue 1 item
14) and the rest of item 15."""
