"""Where the ops that have both a device and a host engine run.

The device engine is the default. NGSTPU_LINK=host pins every such op to
its native host engine; the tests and the host reference run of
chip_smoke.py use it. Any other value is an error rather than a silent
choice of engine.
"""

from __future__ import annotations

import os

PLACEMENTS = ("device", "host")


def placement() -> str:
    """'device' unless NGSTPU_LINK=host; raises on any other value."""
    v = os.environ.get("NGSTPU_LINK") or "device"
    if v not in PLACEMENTS:
        raise ValueError(
            f"NGSTPU_LINK={v!r}: expected one of {', '.join(PLACEMENTS)}")
    return v
