"""The port's Pull mode against the JAX plane on the CPU.

The scenarios of ``tests/test_search_remedy_agent.py`` (``TestPullModeAgent``,
``TestPullClusterLease``) and ``tests/test_pod_runtime_addons.py``
(``TestRegistrationFlow``) run on ``karmada_tpu.controlplane.ControlPlane``
and on the port's (``device="cpu"``) under one injected clock, through
``run_both`` of ``tests/test_torch_controlplane.py``: after every settle the
two planes' states (bindings, Works with their manifest statuses, member
objects, templates, Clusters with their conditions and taints, Leases) must
be equal. Tolerance: exact equality. The JAX tests register Pull members
through ``cli.cmd_token_create`` and ``cli.cmd_register``; the CLI is not
ported (ROADMAP A7c), so ``register`` below makes the calls those commands
make: a CSR against the plane's authority, then ``join_cluster`` in Pull
mode."""

import pytest

import karmada_tpu_torch

from test_torch_controlplane import (  # noqa: F401 (fixtures)
    DELTA_ENV,
    PKGS,
    Pkg,
    _one_torch_thread,
    gates,
    mod,
    only_binding,
    placed,
    run_both,
)

FEATURES = mod(karmada_tpu_torch, "utils.features")


def register(p, cp, name, token=None, **cluster_kw):
    """``cli.cmd_register``: a bootstrap-token CSR, then a Pull join."""
    if token is not None and cp.authority.submit_csr(name, token) is None:
        raise PermissionError(f"invalid or expired bootstrap token for {name}")
    cluster = p.b.new_cluster(name, **cluster_kw)
    cluster.spec.sync_mode = mod(p.pkg, "api.cluster").PULL
    cp.join_cluster(cluster)
    return cluster


def _ready(cp, name):
    return next(c for c in cp.store.get("Cluster", name).status.conditions if c.type == "Ready")


# --------------------------------------------------------------------------
# TestPullModeAgent
# --------------------------------------------------------------------------


def agent_applies_works(p, record):
    cp = p.plane()
    cp.join_cluster(p.b.new_cluster("pusher", cpu="100", memory="200Gi"))
    register(p, cp, "puller", cpu="100", memory="200Gi")
    cp.settle()
    record(cp)
    assert set(cp.agents) == {"puller"}
    cp.store.apply(p.b.new_deployment("app", replicas=2))
    cp.store.apply(p.deployment_policy(p.b.duplicated_placement(), name="p"))
    cp.settle()
    record(cp)
    obj = cp.members.get("puller").get("apps/v1/Deployment", "default", "app")
    assert obj is not None and obj.spec["replicas"] == 2
    rb = only_binding(cp)
    assert {i.cluster_name for i in rb.status.aggregated_status} >= {"puller"}
    # the agent reflects member status back into its Work; the binding
    # status controller aggregates it into the template
    for name in ("pusher", "puller"):
        cp.members.get(name).set_workload_status(
            "apps/v1/Deployment", "default", "app",
            {"replicas": 2, "readyReplicas": 2, "updatedReplicas": 2})
    cp.settle()
    record(cp)
    assert cp.store.get("Resource", "default/app").status.get("readyReplicas") == 4
    # a scale reaches the Push member; the agent, like the JAX agent,
    # creates missing objects and leaves existing ones as they are
    cp.store.apply(p.b.new_deployment("app", replicas=3))
    cp.settle()
    record(cp)
    assert cp.members.get("pusher").get("apps/v1/Deployment", "default", "app") \
        .spec["replicas"] == 3


# --------------------------------------------------------------------------
# TestPullClusterLease
# --------------------------------------------------------------------------


def _pull_plane(p, **kw):
    p.clock.now = 50_000.0
    cp = p.plane(**kw)
    cp.join_cluster(p.b.new_cluster("pusher"))
    token = cp.authority.create_token().token
    register(p, cp, "puller", token=token)
    cp.settle()
    return cp


def lease_renewed_keeps_ready(p, record):
    cp = _pull_plane(p)
    record(cp)
    assert cp.store.get("Lease", "puller").renew_time == p.clock.now
    ready = _ready(cp, "puller")
    assert ready.status and ready.reason == "AgentLeaseRenewed"


def _dead_agent(p, record, grace):
    cp = _pull_plane(p, **({} if grace is None else {"lease_grace_seconds": grace}))
    grace = 120.0 if grace is None else grace
    cp.members.get("puller").reachable = False
    p.clock.now += grace / 2
    cp.settle()
    record(cp)
    assert _ready(cp, "puller").status
    p.clock.now += grace
    cp.settle()
    record(cp)
    ready = _ready(cp, "puller")
    assert not ready.status and ready.reason == "AgentLeaseExpired"
    assert any(t.key == "cluster.karmada.io/not-ready"
               for t in cp.store.get("Cluster", "puller").spec.taints)
    cp.members.get("puller").reachable = True
    p.clock.now += 10
    cp.settle()
    record(cp)
    ready = _ready(cp, "puller")
    assert ready.status and ready.reason == "AgentLeaseRenewed"
    assert not cp.store.get("Cluster", "puller").spec.taints


def dead_agent_default_grace(p, record):
    _dead_agent(p, record, None)


def dead_agent_short_grace(p, record):
    _dead_agent(p, record, 30.0)


def dead_agent_failover(p, record):
    """A Pull member whose agent dies past the grace is tainted NoExecute
    with the Failover gate on, and its binding's replicas move to the Push
    member, leaving a graceful-eviction task for the dead one."""
    cp = _pull_plane(p)
    cp.store.apply(p.b.new_deployment("app", replicas=4))
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement(), name="p"))
    cp.settle()
    record(cp)
    assert set(placed(only_binding(cp))) == {"pusher", "puller"}
    cp.members.get("puller").reachable = False
    p.clock.now += 200
    cp.settle()
    record(cp)
    rb = only_binding(cp)
    assert placed(rb) == {"pusher": 4}
    assert [t.from_cluster for t in rb.spec.graceful_eviction_tasks] == ["puller"]


SCENARIOS = {
    "TestPullModeAgent": (agent_applies_works, ()),
    "TestPullClusterLease-renewed": (lease_renewed_keeps_ready, ()),
    "TestPullClusterLease-dead-agent": (dead_agent_default_grace, ()),
    "TestPullClusterLease-lease-grace-option": (dead_agent_short_grace, ()),
    "TestPullClusterLease-failover": (dead_agent_failover, (FEATURES.FAILOVER,)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_pull_scenario_equals_jax_plane(name, monkeypatch, gates):  # noqa: F811
    scenario, on = SCENARIOS[name]
    for gate in on:
        gates(gate, True)
    run_both(scenario, monkeypatch)


@pytest.mark.parametrize("delta", ["1", "0"])
def test_pull_agent_render_modes_equal_jax_plane(delta, monkeypatch):
    """The agent renders template-delta Works (a reference and a replica
    patch) and full objects alike."""
    monkeypatch.setenv(DELTA_ENV, delta)
    states = run_both(agent_applies_works, monkeypatch)
    refs = [w[3] for w in states[-1]["works"] if w[0].endswith("default.app-deployment")]
    assert len(refs) == 2 and all((r is not None) == (delta == "1") for r in refs)


def test_pull_join_builds_agent_not_push_client():
    """A Pull join builds the port's KarmadaAgent (none for an agent that
    runs out of process), and the execution controller leaves the Pull
    member's Works to the agent."""
    p = Pkg(karmada_tpu_torch)
    cp = p.plane()
    register(p, cp, "agent1")
    agent = cp.agents["agent1"]
    assert type(agent).__module__ == "karmada_tpu_torch.controllers.remedy"
    assert agent.member is cp.members.get("agent1")
    shell = p.b.new_cluster("shell")
    shell.spec.sync_mode = "Pull"
    cp.join_cluster(shell, remote_agent=True)
    assert set(cp.agents) == {"agent1"}
    # the remote agent's heartbeat, as it would arrive through the store
    lease = mod(p.pkg, "api.cluster").Lease(meta=p.core.ObjectMeta(name="shell"),
                                            renew_time=p.clock())
    cp.store.apply(lease)
    cp.store.apply(p.b.new_deployment("app", replicas=1))
    cp.store.apply(p.deployment_policy(p.b.duplicated_placement(), name="p"))
    cp.settle()
    assert cp.members.get("agent1").get("apps/v1/Deployment", "default", "app") is not None
    # nobody applies the shell's Work in process: its agent is elsewhere
    assert cp.members.get("shell").get("apps/v1/Deployment", "default", "app") is None
    ns = p.prop.execution_namespace("shell")
    assert cp.store.get("Work", f"{ns}/default.app-deployment") is not None


# --------------------------------------------------------------------------
# TestRegistrationFlow
# --------------------------------------------------------------------------


def _authority(cp) -> dict:
    """The authority's records, less the random token ids and serials."""
    return {name: (r.cluster, r.issued_at, r.expires_at)
            for name, r in sorted(cp.authority.certificates.items())}


@pytest.mark.parametrize("case", ["issues-cert", "bad-token", "rotation", "expired-token"])
def test_registration_flow_equals_jax(case, monkeypatch):
    seen = []

    def scenario(p, record):
        p.clock.now = 0.0
        cp = p.plane()
        token = cp.authority.create_token().token
        if case == "bad-token":
            with pytest.raises(PermissionError):
                register(p, cp, "pull1", token="aaa.bbb")
            assert cp.store.get("Cluster", "pull1") is None
        elif case == "expired-token":
            p.clock.now = cp.authority.TOKEN_TTL + 1
            with pytest.raises(PermissionError):
                register(p, cp, "pull1", token=token)
        else:
            cluster = register(p, cp, "pull1", token=token)
            assert cluster.spec.sync_mode == "Pull"
            assert cp.authority.approved_csrs == ["pull1"]
        cp.settle()
        record(cp)
        serials = [r.serial for r in cp.authority.certificates.values()]
        if case == "rotation":
            p.clock.now = cp.authority.CERT_TTL * 0.5
            cp.settle()
            assert [r.serial for r in cp.authority.certificates.values()] == serials
            p.clock.now = cp.authority.CERT_TTL * 0.85
            cp.settle()
            record(cp)
            assert [r.serial for r in cp.authority.certificates.values()] != serials
        seen.append((_authority(cp), list(cp.authority.approved_csrs)))

    run_both(scenario, monkeypatch)
    assert seen[0] == seen[1]


def test_registration_authority_equals_jax():
    """``RegistrationAuthority`` alone: tokens validate until their TTL,
    certificates rotate past 80% of theirs, in both packages."""
    out = []
    for pkg in PKGS:
        now = [100.0]
        auth = mod(pkg, "utils.register").RegistrationAuthority(clock=lambda: now[0])
        tok = auth.create_token()
        row = [auth.validate_token(tok.token), auth.validate_token(tok.token_id + ".x"),
               auth.validate_token("nope")]
        rec = auth.submit_csr("c1", tok.token)
        row += [rec.issued_at, rec.expires_at, auth.rotate_if_needed("c1")]
        now[0] += auth.CERT_TTL * 0.79
        row.append(auth.rotate_if_needed("c1"))
        now[0] += auth.CERT_TTL * 0.02
        renewed = auth.rotate_if_needed("c1")
        row += [renewed.issued_at, renewed.expires_at, renewed.serial != rec.serial,
                auth.validate_token(tok.token), auth.approved_csrs]
        now[0] = tok.expires_at
        row.append(auth.validate_token(tok.token))
        out.append(row)
    assert out[0] == out[1]
