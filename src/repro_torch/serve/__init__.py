"""LM serving of the port: the slot-grid session.  The gateway and the
alignment, mapping and genotyping services are ROADMAP queue 1 item 12."""
from .engine import Request, ServeSession

__all__ = ["Request", "ServeSession"]
