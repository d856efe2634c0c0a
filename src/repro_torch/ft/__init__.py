"""Fault tolerance of the port: the heartbeat monitor the gateway beats.
Elastic re-meshing (``repro.ft.elastic``) waits for multi-GPU placement,
ROADMAP queue 1 item 14."""
from .heartbeat import ALIVE, DEAD, STRAGGLER, HeartbeatMonitor

__all__ = ["ALIVE", "DEAD", "STRAGGLER", "HeartbeatMonitor"]
