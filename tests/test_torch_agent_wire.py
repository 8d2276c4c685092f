"""The JAX package's Pull agent processes on the port's store bus, on the
CPU: the cases of ``tests/test_agent_subprocess.py`` (``port_cases``) with
the port's ``ControlPlane`` (``device="cpu"``) and ``StoreBusServer``, and
``python -m karmada_tpu.bus.agent`` as the agent: the JAX agent's mirror
decodes the port server's replay and events, and its Lease, Work status
and leader-election writes pass the port primary's admission, so the same
checks hold as with the port's own agent (``tests/test_torch_agent.py``).

Tolerance: exact equality of what the cases check."""

from port_cases import cpu_plane, port_cases  # noqa: F401 (fixture)

globals().update(port_cases("test_agent_subprocess", swaps=(
    ('"karmada_tpu_torch.bus.agent"', '"karmada_tpu.bus.agent"'),)))
