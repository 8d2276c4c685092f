"""Component child processes: the two helpers of ``karmada_tpu/localup.py``
that the port's process spawners share.

``spawn_child`` starts a component entry point (``python -m
karmada_tpu_torch.estimator``, ``python -m karmada_tpu_torch.solver``) with
its torch device chosen and the package importable from any working
directory, and ``scrape_line`` reads the port line it prints. The rest of
the JAX module (the multi-process ``LocalUp`` orchestrator, the plane
process and its replicas) comes with the CLI and the store bus (ROADMAP
A7c).
"""

from __future__ import annotations

import os
import re
import subprocess
import time


def spawn_child(
    cmd: list[str], device: str = "cuda", extra_env: dict | None = None
) -> subprocess.Popen:
    """Spawn a component child process on torch ``device`` (default the
    card, as every entry point of the port): ``--device DEVICE`` is
    appended to ``cmd`` unless it names one, and a child spawned with
    ``device="cpu"`` sees no CUDA device at all (``CUDA_VISIBLE_DEVICES``
    empty). The package is importable regardless of the caller's cwd.
    ``extra_env`` overlays the inherited environment. Stdout and stderr
    come back merged on ``proc.stdout`` (text)."""
    cmd = list(cmd)
    if "--device" not in cmd:
        cmd += ["--device", device]
    env = dict(os.environ, **(extra_env or {}))
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = (
        pkg_parent + os.pathsep + env["PYTHONPATH"]
        if env.get("PYTHONPATH")
        else pkg_parent
    )
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env,
    )


def scrape_line(proc: subprocess.Popen, pattern: str, timeout: float = 240.0) -> str:
    """First regex group of the first stdout line matching ``pattern``.

    select()-gated so a child that hangs BEFORE printing (import stall,
    bind wait) raises after ``timeout`` instead of blocking readline
    forever; a child that dies mid-startup raises immediately — with its
    recent output in the error, so startup failures are diagnosable from
    the orchestrator's traceback alone."""
    import collections
    import select

    tail: collections.deque = collections.deque(maxlen=15)

    def die(reason: str) -> None:
        if proc.poll() is not None:
            try:
                rest = proc.stdout.read() or ""
                tail.extend(rest.splitlines()[-10:])
            except Exception:  # noqa: BLE001 — best-effort diagnostics
                pass
        out = "\n".join(f"    | {ln.rstrip()}" for ln in tail)
        raise RuntimeError(
            f"{reason} (cmd: {' '.join(proc.args[:6])}...)\n"
            f"  recent child output:\n{out or '    | <none>'}"
        )

    deadline = time.time() + timeout
    while True:
        remaining = deadline - time.time()
        if remaining <= 0:
            die(f"no line matching {pattern!r} within {timeout}s")
        ready, _, _ = select.select([proc.stdout], [], [], min(remaining, 0.5))
        if not ready:
            if proc.poll() is not None:
                die(f"child exited rc={proc.returncode} during startup")
            continue
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                die(f"child exited rc={proc.returncode} during startup")
            time.sleep(0.05)  # stdout closed but child alive: avoid spin
            continue
        tail.append(line)
        m = re.search(pattern, line)
        if m:
            return m.group(1)
