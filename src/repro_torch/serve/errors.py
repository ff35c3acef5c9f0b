"""Serving-tier error taxonomy.

Three failure classes the tier treats differently:

* ``QueueFull`` — backpressure: a bounded submit queue is at capacity.
  Raised synchronously to the caller (never queued), so producers see
  overload immediately instead of watching latency grow without bound.
* ``TransientError`` — retryable: the attempt failed for a reason that
  is expected to clear (flaky I/O, a timed-out tick).  The service
  re-enqueues the request with exponential backoff up to its retry
  budget.
* anything else raised by the engine — permanent for that request: the
  bisecting re-execution in ``GnnPeEngine.match_many_isolated``
  quarantines the raising query (error response with a structured
  reason) while the rest of the batch completes normally.

A fourth class is no request's fault and is never absorbed: a kernel
that does not build (``kernels.build.KernelBuildError``) or launch
(``KernelLaunchError``) and a CUDA error of the device
(``device.is_device_fault``).  The engine's isolation, the server's
tick, the standing-query registry and the service's retry path all
re-raise it, so it fails the run instead of becoming an error status.
"""
from __future__ import annotations

__all__ = ["ServeError", "QueueFull", "TransientError", "PoisonedQueryError"]


class ServeError(Exception):
    """Base class for serving-tier errors."""


class QueueFull(ServeError):
    """A bounded submit queue is at capacity — resubmit later."""


class TransientError(ServeError):
    """A retryable fault: the serving tier retries with backoff.

    The ``transient`` marker is duck-typed so ``core`` never imports
    ``serve``: ``GnnPeEngine.match_many_isolated`` sees it and fails the
    whole attempt instead of bisecting (the fault is about the attempt,
    not any particular query)."""

    transient = True


class PoisonedQueryError(ServeError):
    """Fault injection's stand-in for a request that deterministically
    crashes the engine (a malformed query) — NOT transient, so it must
    be quarantined, never retried."""
