"""Admission webhooks (ref: pkg/webhook): the in-process admission chain the
control plane's store runs on every apply and delete. The JAX package's TLS
webhook server is not part of the port."""

from .chain import AdmissionChain, ValidationError, default_admission_chain  # noqa: F401
