"""The fused scheduling step (single device; the mesh form is not ported)."""

from .solver import schedule_step, schedule_step_interned  # noqa: F401
