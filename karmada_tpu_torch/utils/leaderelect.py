"""Leader election over a Lease resource lock: the port's own copy of
``karmada_tpu/utils/leaderelect.py``.

Ref: client-go tools/leaderelection (LeasesResourceLock) as every reference
binary uses it via ``--leader-elect`` (controller-manager, scheduler,
descheduler, agent option structs). The algorithm is tryAcquireOrRenew:
read the lease, and if it is unheld, expired, or held by us, write our
claim with an optimistic-concurrency precondition
(``Store.apply(expected_rv=...)`` — the apiserver
Update-with-resourceVersion 409 contract). The CAS loser simply
observes the winner's lease.

Unlike client-go this elector is TICK-driven, not thread-driven: the owner
calls :meth:`tick` from its own loop (the agent/serve loops already run on
a cadence), which keeps it deterministic under the test runtime and free of
background threads in the cooperative control plane.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..api.cluster import Lease
from ..api.core import ObjectMeta
from .store import ConflictError

__all__ = ["LeaderElector"]


class LeaderElector:
    """CAS-based leader election on a named Lease.

    ``store`` needs get/apply with the ``expected_rv`` precondition — the
    in-proc Store, the bus StoreReplica, and the agent's facade all
    qualify, so election works identically in-process and across the DCN.

    State transitions surface via ``on_started_leading`` /
    ``on_stopped_leading``; ``is_leader`` is authoritative between ticks
    only up to ``renew_deadline`` — a leader that cannot renew within it
    must consider itself deposed (clock-skew guard, leaderelection.go's
    renewDeadline contract)."""

    def __init__(
        self,
        store,
        name: str,
        identity: str,
        *,
        lease_duration: float = 15.0,
        renew_deadline: float = 10.0,
        clock: Callable[[], float] = time.time,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ) -> None:
        if renew_deadline >= lease_duration:
            raise ValueError("renew_deadline must be < lease_duration")
        self.store = store
        self.name = name
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.clock = clock
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leading = False
        self._last_renew = 0.0

    @property
    def is_leader(self) -> bool:
        return self._leading

    def tick(self) -> bool:
        """One tryAcquireOrRenew round. Returns leadership after it."""
        now = self.clock()
        lease: Optional[Lease] = self.store.get("Lease", self.name)
        held_by_other = (
            lease is not None
            and lease.holder_identity not in ("", self.identity)
            and now < lease.renew_time + lease.lease_duration_seconds
        )
        if held_by_other:
            # another candidate holds a live lease: deposed immediately
            # (unlike a transient renew failure, there is no ambiguity)
            self._step_down()
            return False

        claim = Lease(
            meta=ObjectMeta(name=self.name),
            renew_time=now,
            holder_identity=self.identity,
            lease_duration_seconds=self.lease_duration,
            acquire_time=(
                lease.acquire_time
                if lease is not None and lease.holder_identity == self.identity
                else now
            ),
            lease_transitions=(
                lease.lease_transitions
                + (1 if lease.holder_identity != self.identity else 0)
                if lease is not None
                else 0
            ),
        )
        try:
            self.store.apply(
                claim,
                expected_rv=(
                    lease.meta.resource_version if lease is not None else 0
                ),
            )
        except ConflictError:
            # raced a concurrent writer — or, over a bus replica, our own
            # previous write's echo has not landed in the mirror yet (reads
            # are async there). Defer judgment: the next tick's read shows
            # the true holder; the renew deadline bounds the coast.
            if self._leading and now - self._last_renew >= self.renew_deadline:
                self._step_down()
            return self._leading
        except Exception:
            # bus unreachable etc.: cannot renew — step down only once the
            # renew deadline passes (transient write failures must not
            # flap leadership)
            if self._leading and now - self._last_renew >= self.renew_deadline:
                self._step_down()
            return self._leading
        self._last_renew = now
        if not self._leading:
            self._leading = True
            if self.on_started_leading is not None:
                self.on_started_leading()
        return True

    def _step_down(self) -> None:
        if self._leading:
            self._leading = False
            if self.on_stopped_leading is not None:
                self.on_stopped_leading()

    def release(self) -> None:
        """Voluntarily drop the lease (leaderelection.go's ReleaseOnCancel):
        zero the holder so a standby acquires without waiting out the
        expiry."""
        lease: Optional[Lease] = self.store.get("Lease", self.name)
        if lease is None or lease.holder_identity != self.identity:
            return
        lease.holder_identity = ""
        lease.renew_time = 0.0
        try:
            self.store.apply(
                lease, expected_rv=lease.meta.resource_version
            )
        except Exception:  # noqa: BLE001 — best-effort on shutdown
            pass
        self._step_down()
