"""HTTP data acquisition.

Reference behavior (Main.java:37-58): single GET of the EuroMillions
results page, response handler that accepts status in [200, 300) and throws
otherwise, preceded by a random ≤1 s sleep "to avoid bot detection"
(Main.java:53-54). Here: stdlib urllib + the framework retry policy — the
pre-jitter reproduces the anti-bot sleep, and non-2xx raises a structured
``FetchError`` instead of the reference's catch-all (Main.java:144-147).

Retryability is a predicate over the structured error (status-based), not a
marker subclass: network errors (no status), 5xx, and 429 retry with
backoff; other 4xx fail fast. ``fault_point("fetch.request")`` lets the
chaos harness inject 5xx storms before any socket is opened.
"""

from __future__ import annotations

import http.client
import urllib.error
import urllib.request

from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.utils.errors import FetchError
from euromillioner_tpu_torch.utils.logging_utils import get_logger
from euromillioner_tpu_torch.utils.retry import RetryPolicy, retry_with_backoff

logger = get_logger("data.fetch")

_UA = "Mozilla/5.0 (X11; Linux x86_64) euromillioner-tpu/0.1"


def is_retryable_fetch_error(e: BaseException) -> bool:
    """Transient acquisition failures: network errors (``status is None``),
    server-side 5xx, and 429 rate limiting. Permanent 4xx are not."""
    return isinstance(e, FetchError) and (
        e.status is None or e.status >= 500 or e.status == 429)


def fetch_url(
    url: str,
    *,
    timeout_s: float = 30.0,
    policy: RetryPolicy = RetryPolicy(),
) -> str:
    """GET ``url`` and return the decoded body; transient failures retry
    with backoff, permanent (non-429 4xx) failures raise immediately."""

    def once() -> str:
        fault_point("fetch.request", url=url)
        req = urllib.request.Request(url, headers={"User-Agent": _UA})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                status = resp.status
                # Reference accepts [200, 300) only (Main.java:44-50).
                if not (200 <= status < 300):
                    raise FetchError(
                        f"Unexpected response status: {status}", status=status)
                charset = resp.headers.get_content_charset() or "utf-8"
                return resp.read().decode(charset, errors="replace")
        except FetchError:
            raise
        except urllib.error.HTTPError as e:
            raise FetchError(
                f"Unexpected response status: {e.code}", status=e.code) from e
        except urllib.error.URLError as e:
            raise FetchError(f"Could not access URL - {e.reason}") from e
        except (OSError, http.client.HTTPException) as e:
            # Mid-body failures — connection reset / timeout / IncompleteRead
            # during resp.read() — are network errors too: they must stay
            # inside the FetchError taxonomy (status=None → retryable) or
            # they'd bypass both retry and the stale-cache degradation.
            raise FetchError(f"Could not read response - {e!r}") from e

    logger.info("fetching %s", url)
    return retry_with_backoff(
        once, policy=policy, retry_on=(), retry_if=is_retryable_fetch_error,
        description=f"GET {url}")
