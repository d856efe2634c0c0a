"""Fault tolerance of the port: the heartbeat monitor the gateway beats,
and elastic re-meshing after failures (``elastic``: ``plan_mesh``,
``make_mesh``, ``resume_on``)."""
from .heartbeat import ALIVE, DEAD, STRAGGLER, HeartbeatMonitor

__all__ = ["ALIVE", "DEAD", "STRAGGLER", "HeartbeatMonitor"]
