"""The port's Pull agent process (``python -m karmada_tpu_torch.bus.agent``)
against the JAX package on the CPU: the cases of
``tests/test_agent_subprocess.py`` run whole on the port (``port_cases``):
the port's ``ControlPlane`` (``device="cpu"``) behind the port's
``StoreBusServer``, and agent processes of the port that mirror it over
gRPC: a Pull cluster Ready from the agent's Lease, a Work applied and its
status reflected, the failover once the agent dies; the agent's writes
admitted by the primary; two agents electing one leader on a Lease and
the standby taking over.

``tests/test_torch_agent_wire.py`` runs the same cases with the JAX
package's agent processes on the port's bus, and
``tests/test_torch_ha_process.py`` the port's agents on the JAX package's
bus process.

Tolerance: exact equality of what the cases check."""

from port_cases import cpu_plane, port_cases  # noqa: F401 (fixture)

globals().update(port_cases("test_agent_subprocess"))
