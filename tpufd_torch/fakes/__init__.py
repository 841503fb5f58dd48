"""The port's own copy of ``tpufd.fakes`` (``tpufd/fakes/__init__.py``),
kept equal to it and importing nothing of ``tpufd``.

Hermetic fakes (metadata server, apiserver) + tiny shared test-infra
helpers for the harnesses that drive the real daemon."""

import socket


def free_loopback_port():
    """An ephemeral loopback port for a daemon under test (introspection
    server, fakes). Bind+close has an inherent reuse race, but every
    consumer re-binds with SO_REUSEADDR moments later and the harnesses
    run daemons serially — the ONE home of this idiom and its caveat
    (soak, metrics-lint, and the introspection tests all use it)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
