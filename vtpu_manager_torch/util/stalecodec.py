"""The `...@ts` staleness stamp of the node annotations the port publishes.

The port of the part of the JAX package's `util/stalecodec.py` that the
pressure annotation uses (`telemetry/pressure.py`): the stamp is appended
as `@{ts:.3f}`, split off the last `@` (a missing, non-float or non-finite
stamp is no signal), and a stamp is fresh when `-skew <= now - ts <=
max_age`. The scheduler decodes what the port writes with the JAX copy of
these rules, so the bytes must not drift.
"""

from __future__ import annotations

import math
import time

# a stamp slightly in the future is clock skew plus the encoder's rounding
FUTURE_SKEW_TOLERANCE_S = 5.0


def stamp(body: str, ts: float) -> str:
    return f"{body}@{ts:.3f}"


def split_stamp(raw: str | None, max_len: int | None = None
                ) -> tuple[str, float] | None:
    """(body, ts) off the last `@`; None for every bad shape."""
    if not raw:
        return None
    if max_len is not None and len(raw) > max_len:
        return None
    body, sep, ts_raw = raw.rpartition("@")
    if not sep:
        return None
    try:
        ts = float(ts_raw)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(ts):
        return None
    return body, ts


def is_fresh(ts: float, now: float | None = None,
             max_age_s: float = 120.0,
             skew_s: float = FUTURE_SKEW_TOLERANCE_S) -> bool:
    now = time.time() if now is None else now
    return -skew_s <= now - ts <= max_age_s
