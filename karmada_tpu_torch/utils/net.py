"""Small shared networking helpers."""

from __future__ import annotations


def parse_hostport(spec: str, default_host: str = "127.0.0.1") -> tuple[str, int]:
    """``HOST:PORT`` / ``:PORT`` / ``PORT-less`` spec -> (host, port);
    missing pieces default (port 0 = ephemeral bind)."""
    host, _, port = spec.partition(":")
    return (host or default_host, int(port or 0))
