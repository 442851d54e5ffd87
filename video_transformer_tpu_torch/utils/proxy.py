"""Key-pool proxy health checks (optional cloud seam).

This package's own copy of the JAX package's ``utils/proxy.py``, pinned to it by
the CPU parity tests (``tests/test_torch_pipeline_pure.py``).

Local inference on the card consumes no API keys, so these are no-ops in the default
deployment; the protocol (GET /health, POST /sdk/allocate-key accepting
200/503) is preserved for installations that keep a cloud fallback
(reference src/utils/proxy.py, README.md:167-179). ``requests`` is imported
lazily: where it is not installed, both checks return False, as they do
when no key pool answers.
"""

from __future__ import annotations

__all__ = ["verify_proxy_connection", "verify_sdk_endpoint"]


def verify_proxy_connection(
    base_url: str, timeout: int = 5, verify_ssl: bool = True
) -> bool:
    """GET {base}/health -> 200."""
    try:
        import requests

        response = requests.get(
            f"{base_url.rstrip('/')}/health", timeout=timeout, verify=verify_ssl
        )
        return response.status_code == 200
    except Exception:
        return False


def verify_sdk_endpoint(base_url: str, timeout: int = 5) -> bool:
    """POST {base}/sdk/allocate-key -> 200 (key) or 503 (pool up, exhausted)."""
    try:
        import requests

        response = requests.post(
            f"{base_url.rstrip('/')}/sdk/allocate-key", timeout=timeout
        )
        return response.status_code in (200, 503)
    except Exception:
        return False
