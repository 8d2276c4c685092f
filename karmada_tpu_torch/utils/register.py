"""Pull-mode registration: token bootstrap + certificate records.

The port's own copy of ``karmada_tpu/utils/register.py``. Ref:
pkg/karmadactl/register (kubeadm-style token -> CSR -> signed agent cert
flow) and the agent-CSR-approving + cert-rotation controllers
(controllermanager.go:241, pkg/controllers/certificate/). The in-proc
transport needs no PKI, so this layer keeps the *protocol shape* — bootstrap
tokens with expiry, CSR records approved by the control plane, rotatable
certificate records — behind which a real PKI slots in.
"""

from __future__ import annotations

import secrets
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class BootstrapToken:
    token_id: str
    secret: str
    expires_at: float

    @property
    def token(self) -> str:
        return f"{self.token_id}.{self.secret}"


@dataclass
class CertificateRecord:
    cluster: str
    issued_at: float
    expires_at: float
    serial: str

    def needs_rotation(self, now: float, threshold: float = 0.2) -> bool:
        """Rotate when less than ``threshold`` of the lifetime remains."""
        lifetime = self.expires_at - self.issued_at
        return (self.expires_at - now) < lifetime * threshold


class RegistrationAuthority:
    """Token issuance + CSR approval + certificate rotation bookkeeping."""

    TOKEN_TTL = 24 * 3600.0
    CERT_TTL = 365 * 24 * 3600.0

    def __init__(self, clock=time.time):
        self.clock = clock
        self._tokens: dict[str, BootstrapToken] = {}
        self.certificates: dict[str, CertificateRecord] = {}
        self.approved_csrs: list[str] = []

    def create_token(self) -> BootstrapToken:
        """karmadactl token create."""
        tok = BootstrapToken(
            token_id=secrets.token_hex(3),
            secret=secrets.token_hex(8),
            expires_at=self.clock() + self.TOKEN_TTL,
        )
        self._tokens[tok.token_id] = tok
        return tok

    def validate_token(self, token: str) -> bool:
        token_id, _, secret = token.partition(".")
        tok = self._tokens.get(token_id)
        return (
            tok is not None
            and tok.secret == secret
            and tok.expires_at > self.clock()
        )

    def submit_csr(self, cluster: str, token: str) -> Optional[CertificateRecord]:
        """Agent bootstrap: CSR auto-approved for valid tokens
        (agent-CSR-approving controller)."""
        if not self.validate_token(token):
            return None
        now = self.clock()
        record = CertificateRecord(
            cluster=cluster,
            issued_at=now,
            expires_at=now + self.CERT_TTL,
            serial=secrets.token_hex(8),
        )
        self.certificates[cluster] = record
        self.approved_csrs.append(cluster)
        return record

    def rotate_if_needed(self, cluster: str) -> Optional[CertificateRecord]:
        """cert-rotation controller sweep."""
        record = self.certificates.get(cluster)
        if record is None or not record.needs_rotation(self.clock()):
            return None
        now = self.clock()
        renewed = CertificateRecord(
            cluster=cluster,
            issued_at=now,
            expires_at=now + self.CERT_TTL,
            serial=secrets.token_hex(8),
        )
        self.certificates[cluster] = renewed
        return renewed
