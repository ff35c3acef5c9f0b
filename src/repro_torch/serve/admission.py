"""Per-tenant admission control for the async serving tier.

One shared engine fronts many tenants; admission makes sure no tenant
can starve the rest or grow state without bound:

* **token-bucket quotas** — each tenant refills ``rate`` tokens/s up to
  ``burst``; a submit with an empty bucket is REJECTED (``tenant-quota``)
  before it touches the queue, so a runaway client pays its own cost.
* **bounded backlog** — at most ``max_backlog`` admitted-but-unfinished
  requests per tenant (queued, in flight, or in retry backoff).  Beyond
  that, REJECTED (``tenant-backlog``): one slow tenant's pile-up cannot
  consume the global queue.
* **subscription caps** — at most ``max_subscriptions`` live standing
  queries per tenant (serve/standing.py).  A subscription is long-lived
  state the engine pays for on every update tick, so it is capped by
  count, not by rate: ``admit_subscription`` at registration,
  ``release_subscription`` when it ends (unsubscribe, shed, quarantine).

Admission answers only the per-tenant question; the *global* queue cap
and the shed policy under overload (drop-lowest-priority, cache-hit
fast path) live in serve/service.py, which sees the whole queue.

``release`` must be called exactly once per admitted request when it
reaches any terminal state — that is what "backlog" means here.
"""
from __future__ import annotations

import dataclasses
import time

from ..obs.metrics import REGISTRY as _OBS

# cumulative admission outcomes across all controllers, by reason —
# the per-tenant split stays on AdmissionController.stats()
_M_ADMIT = _OBS.counter(
    "gnnpe_admission_decisions_total",
    "Admission decisions by outcome reason",
    labels=("reason",),
)

__all__ = ["TenantQuota", "AdmissionConfig", "AdmissionController", "DEFAULT_TENANT"]

DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    rate: float = float("inf")  # sustained admits/s (token refill rate)
    burst: float = 64.0  # bucket capacity (instantaneous burst)
    max_backlog: int = 64  # admitted-but-unfinished cap
    max_subscriptions: int = 16  # live standing queries per tenant


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    default_quota: TenantQuota = TenantQuota()
    # per-tenant overrides: tenant name -> TenantQuota
    quotas: dict = dataclasses.field(default_factory=dict)


class _TokenBucket:
    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, quota: TenantQuota, now: float):
        self.rate = quota.rate
        self.burst = quota.burst
        self.tokens = quota.burst  # start full: a fresh tenant may burst
        self.t_last = now

    def try_take(self, now: float) -> bool:
        self.tokens = min(self.burst, self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclasses.dataclass
class _TenantState:
    bucket: _TokenBucket
    backlog: int = 0
    admitted: int = 0
    rejected: int = 0
    subscriptions: int = 0  # live standing queries


class AdmissionController:
    def __init__(self, cfg: AdmissionConfig = AdmissionConfig(), clock=time.monotonic):
        self.cfg = cfg
        self._clock = clock
        self._tenants: dict[str, _TenantState] = {}

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            quota = self.cfg.quotas.get(tenant, self.cfg.default_quota)
            st = _TenantState(bucket=_TokenBucket(quota, self._clock()))
            self._tenants[tenant] = st
        return st

    def quota(self, tenant: str) -> TenantQuota:
        return self.cfg.quotas.get(tenant, self.cfg.default_quota)

    # ------------------------------------------------------------------
    def admit(self, tenant: str) -> tuple[bool, str]:
        """Charge one request against ``tenant``.  Returns ``(admitted,
        reason)``; on success the tenant's backlog grows by one until
        ``release``."""
        st = self._state(tenant)
        if st.backlog >= self.quota(tenant).max_backlog:
            st.rejected += 1
            _M_ADMIT.labels(reason="tenant-backlog").inc()
            return False, "tenant-backlog"
        if not st.bucket.try_take(self._clock()):
            st.rejected += 1
            _M_ADMIT.labels(reason="tenant-quota").inc()
            return False, "tenant-quota"
        st.backlog += 1
        st.admitted += 1
        _M_ADMIT.labels(reason="admitted").inc()
        return True, ""

    def release(self, tenant: str) -> None:
        """One admitted request reached a terminal state."""
        st = self._tenants.get(tenant)
        if st is not None and st.backlog > 0:
            st.backlog -= 1

    # ------------------------------------------------------------------
    def admit_subscription(self, tenant: str) -> tuple[bool, str]:
        """Charge one standing-query registration against ``tenant``'s
        subscription cap (count-based — no token cost; per-delta work is
        already bounded by the registry's skip/probe machinery)."""
        st = self._state(tenant)
        if st.subscriptions >= self.quota(tenant).max_subscriptions:
            st.rejected += 1
            _M_ADMIT.labels(reason="tenant-subscriptions").inc()
            return False, "tenant-subscriptions"
        st.subscriptions += 1
        _M_ADMIT.labels(reason="subscription-admitted").inc()
        return True, ""

    def release_subscription(self, tenant: str) -> None:
        """One subscription ended (unsubscribed, shed, or quarantined)."""
        st = self._tenants.get(tenant)
        if st is not None and st.subscriptions > 0:
            st.subscriptions -= 1

    # ------------------------------------------------------------------
    def backlog(self, tenant: str) -> int:
        st = self._tenants.get(tenant)
        return st.backlog if st is not None else 0

    def subscriptions(self, tenant: str) -> int:
        st = self._tenants.get(tenant)
        return st.subscriptions if st is not None else 0

    def stats(self) -> dict:
        return {
            t: {
                "backlog": st.backlog,
                "admitted": st.admitted,
                "rejected": st.rejected,
                "subscriptions": st.subscriptions,
            }
            for t, st in sorted(self._tenants.items())
        }
