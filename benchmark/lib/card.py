"""The card's clocks and power limit, as nvidia-smi reads them."""

from __future__ import annotations

import subprocess


def sm_clock() -> str:
    """"<SM MHz> MHz of <max> MHz, <draw> W of <limit> W" for card 0, or
    why it could not be read."""
    query = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,power.limit",
             "--format=csv,noheader,nounits", "-i", "0"]
    try:
        out = subprocess.run(query, capture_output=True, text=True, timeout=30, check=True).stdout
        sm, sm_max, draw, limit = [x.strip() for x in out.strip().splitlines()[0].split(",")]
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        return f"not read ({type(e).__name__})"
    return f"{sm} MHz of {sm_max} MHz, {draw} W of {limit} W"
