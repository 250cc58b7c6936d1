"""A live dump of every thread's stack, for the exporter's
`/debug/stacks` (`--debug-endpoints`).

The port of the JAX package's `util/debug.py` (`format_stacks`); the
exporter serves it over its own `http.server` handler, so the JAX
package's aiohttp handler has no counterpart here.
"""

from __future__ import annotations

import sys
import threading
import traceback


def format_stacks() -> str:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)
