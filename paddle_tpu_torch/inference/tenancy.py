"""Multi-tenant registry + deficit-round-robin fairness state.

Copied from ``paddle_tpu/inference/tenancy.py`` (the port never imports
the JAX package).

One fleet, N tenants: a tenant is a named traffic class that owns a
model (or adapter) id, an admission token budget, a priority ceiling,
and a fairness weight.  ``TenantRegistry`` is pure host-side accounting
— the :class:`~paddle_tpu_torch.inference.control_plane.ServingFrontend`
consults it at admission (budget + ceiling), at dispatch (deficit
round-robin across backlogged tenants, above the existing priority
classes), and at routing (send a tenant's requests to replicas already
holding its model, or swap an idle replica on demand via
``model_provider``).  This module deliberately imports nothing from the
control plane: priorities travel as plain ints and replicas as duck
types, so the registry is reusable from tests/benches without a
frontend.

Fairness contract (DRR).  Each frontend dispatch round credits every
*backlogged* tenant ``quantum * weight`` deficit tokens; a tenant's
queued request is placed only while its cost (remaining new tokens)
fits the accumulated deficit, and placement debits it.  A tenant whose
queue drains forfeits its remaining deficit (classic DRR reset — an idle tenant
cannot bank credit and later burst past everyone).  Over any window in
which two tenants are both continuously backlogged, their served-token
shares converge to the ratio of their weights, independent of request
sizes or arrival pattern.  Priorities still order work WITHIN a tenant;
fairness is enforced ACROSS tenants first.

Budget contract.  ``token_budget`` caps a tenant's *outstanding*
admitted tokens (prompt + max_new, released at terminal) — the
admission-time analogue of the frontend's per-class budgets, so a
bursty tenant is typed-rejected at submit instead of starving a steady
tenant's queue.  ``priority_ceiling`` clamps the class a tenant may
request (a tenant cannot buy HIGH by asking for it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

__all__ = ["TenantSpec", "TenantRegistry", "DEFAULT_TENANT"]

DEFAULT_TENANT = "default"


@dataclass
class TenantSpec:
    """One tenant's static contract.

    ``model_id`` names the weights the tenant's requests must run
    against (``"default"`` = whatever the fleet booted with);
    ``token_budget`` caps outstanding admitted tokens (None =
    unlimited); ``priority_ceiling`` is the best (numerically lowest)
    priority class the tenant may claim (None = any); ``weight`` scales
    the tenant's DRR quantum."""
    name: str
    model_id: str = "default"
    token_budget: Optional[int] = None
    priority_ceiling: Optional[int] = None
    weight: float = 1.0

    def clamp_priority(self, priority: int) -> int:
        """Clamp a requested class to the tenant's ceiling (priorities
        are IntEnum values where LOWER is better, so the ceiling is a
        floor on the int)."""
        if self.priority_ceiling is None:
            return int(priority)
        return max(int(priority), int(self.priority_ceiling))


class TenantRegistry:
    """Tenant specs + live fairness/budget accounting.

    ``model_provider`` (optional) maps a ``model_id`` to whatever the
    fleet's replicas accept in ``load_weights`` — a model instance for
    in-process engines, a worker spec dict for ``RemoteReplica`` — and
    arms swap-on-demand routing: an idle replica is re-weighted to a
    tenant's model when none of its replicas currently hold it.
    Without a provider, ``model_id`` is a routing preference only.
    """

    def __init__(self, tenants: Optional[List[TenantSpec]] = None, *,
                 quantum: int = 64,
                 model_provider: Optional[Callable[[str], object]] = None):
        self.quantum = int(quantum)
        self.model_provider = model_provider
        self._specs: Dict[str, TenantSpec] = {
            DEFAULT_TENANT: TenantSpec(DEFAULT_TENANT)}
        self._deficit: Dict[str, float] = {}
        self._outstanding: Dict[str, int] = {}
        self._served: Dict[str, int] = {}
        self._cursor = 0
        for spec in tenants or ():
            self.add(spec)

    # ------------------------------------------------------------- specs
    def add(self, spec: TenantSpec) -> TenantSpec:
        self._specs[spec.name] = spec
        return spec

    def get(self, name: Optional[str]) -> TenantSpec:
        """Resolve a tenant name (None/unknown → the default tenant)."""
        if name is None:
            return self._specs[DEFAULT_TENANT]
        return self._specs.get(name, self._specs[DEFAULT_TENANT])

    def resolve(self, name: Optional[str]) -> str:
        """Canonical tenant name for accounting (unknown → default)."""
        return self.get(name).name

    def names(self) -> List[str]:
        return list(self._specs)

    # ------------------------------------------------------------ budget
    def outstanding(self, name: Optional[str]) -> int:
        return self._outstanding.get(self.resolve(name), 0)

    def served(self, name: Optional[str]) -> int:
        return self._served.get(self.resolve(name), 0)

    def budget_allows(self, name: Optional[str], tokens: int) -> bool:
        spec = self.get(name)
        if spec.token_budget is None:
            return True
        return self.outstanding(name) + int(tokens) <= spec.token_budget

    def charge(self, name: Optional[str], tokens: int) -> None:
        key = self.resolve(name)
        self._outstanding[key] = self._outstanding.get(key, 0) + int(tokens)

    def release(self, name: Optional[str], tokens: int) -> None:
        key = self.resolve(name)
        self._outstanding[key] = max(
            0, self._outstanding.get(key, 0) - int(tokens))

    def note_served(self, name: Optional[str], tokens: int) -> None:
        key = self.resolve(name)
        self._served[key] = self._served.get(key, 0) + int(tokens)

    # --------------------------------------------------------------- DRR
    def rotation(self, backlogged: List[str]) -> List[str]:
        """Backlogged tenants in round-robin order starting after the
        cursor; advances the cursor so the next round starts one past
        this round's first tenant (no tenant is permanently first)."""
        order = sorted(set(self.resolve(n) for n in backlogged))
        if not order:
            return []
        start = self._cursor % len(order)
        self._cursor = (self._cursor + 1) % max(len(order), 1)
        return order[start:] + order[:start]

    def add_deficit(self, name: str) -> None:
        """Credit one round's quantum (scaled by weight)."""
        spec = self.get(name)
        key = spec.name
        self._deficit[key] = (self._deficit.get(key, 0.0)
                              + self.quantum * float(spec.weight))

    def deficit(self, name: str) -> float:
        return self._deficit.get(self.resolve(name), 0.0)

    def charge_deficit(self, name: str, cost: int) -> None:
        key = self.resolve(name)
        self._deficit[key] = self._deficit.get(key, 0.0) - float(cost)

    def reset_deficit(self, name: str) -> None:
        """Classic DRR: a tenant whose queue drained forfeits unused
        credit — idle tenants cannot bank deficit and burst later."""
        self._deficit.pop(self.resolve(name), None)

    # ------------------------------------------------------------- stats
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant accounting view (tests / gauges / benches)."""
        out: Dict[str, Dict[str, float]] = {}
        for name in self._specs:
            out[name] = {
                "outstanding": float(self._outstanding.get(name, 0)),
                "served": float(self._served.get(name, 0)),
                "deficit": float(self._deficit.get(name, 0.0)),
            }
        return out
