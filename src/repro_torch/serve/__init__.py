"""Serving of the port: the slot-grid LM session, the unified gateway and
the alignment, read-mapping and genotyping services on it."""
from .engine import Request, ServeSession
from .gateway import (Channel, DeadlineExceeded, FaultPlan, Gateway,
                      GatewayError, GatewayTimeout, InflightBatch,
                      InjectedFault, RetriesExhausted, ServiceOverloaded,
                      ShedOverload, WorkerKilled, error_result)
from .alignment_service import AlignFuture, AlignRequest, AlignmentService
from .mapping_service import MapRequest, ReadMappingService
from .genotyping_service import (GenotypeFuture, GenotypeRequest,
                                 GenotypingService)

__all__ = [
    "Request", "ServeSession",
    "Channel", "DeadlineExceeded", "FaultPlan", "Gateway", "GatewayError",
    "GatewayTimeout", "InflightBatch", "InjectedFault", "RetriesExhausted",
    "ServiceOverloaded", "ShedOverload", "WorkerKilled", "error_result",
    "AlignFuture", "AlignRequest", "AlignmentService",
    "MapRequest", "ReadMappingService",
    "GenotypeFuture", "GenotypeRequest", "GenotypingService",
]
