"""Admission webhooks (ref: pkg/webhook): the in-process admission chain the
control plane's store runs on every apply and delete, and the same chain
behind HTTP(S) (``server.py``: ``AdmissionWebhookServer`` and the store's
``RemoteAdmission`` hooks)."""

from .chain import AdmissionChain, ValidationError, default_admission_chain  # noqa: F401
