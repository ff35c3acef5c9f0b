from .metrics import REGISTRY, Counter, MetricsRegistry

__all__ = ["REGISTRY", "Counter", "MetricsRegistry"]
