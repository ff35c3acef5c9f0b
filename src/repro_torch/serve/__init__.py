"""Serving front ends of the port: the LM decode engine, and GNN-PE's
signature-keyed result cache, batched ``MatchServer``, standing queries
and the async multi-tenant ``MatchService``, with their admission
control, error taxonomy and fault injector."""
from .admission import AdmissionConfig, AdmissionController, TenantQuota
from .cache import CacheStats, ResultCache, canonical_matches, remap_matches
from .engine import DecodeEngine, ServeConfig
from .errors import PoisonedQueryError, QueueFull, ServeError, TransientError
from .faults import FaultSpec, FlakyEngine
from .match_server import MatchServeConfig, MatchServer
from .service import MatchService, Response, ServiceConfig, SubscriptionHandle
from .standing import (
    MatchDelta,
    StandingQueryRegistry,
    StandingState,
    Subscription,
    advance_standing,
)

__all__ = [
    "DecodeEngine", "ServeConfig", "ResultCache", "CacheStats", "canonical_matches",
    "remap_matches", "ServeError", "QueueFull", "TransientError", "PoisonedQueryError",
    "TenantQuota", "AdmissionConfig", "AdmissionController", "FaultSpec", "FlakyEngine",
    "MatchServeConfig", "MatchServer", "MatchDelta", "StandingState", "Subscription",
    "StandingQueryRegistry", "advance_standing", "ServiceConfig", "Response",
    "SubscriptionHandle", "MatchService",
]
