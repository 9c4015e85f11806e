"""What a cell's loop hands back to ``benchmark.run``."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .counts import Work


@dataclasses.dataclass
class Result:
    setup_s: float
    trace: Optional[Dict]           # trace.reduce_events of a traced window
    works: List[Work]               # counted operations and bytes of the window's work
    items: int                      # images or pairs completed in the window
    steps: int                      # requests or training steps completed in the window
    attempted: int
    failed: int
    memory_peak_bytes: int
    span_seconds: Dict[str, float]
    metrics: Dict[str, Tuple[float, str]] = dataclasses.field(default_factory=dict)
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)
    # name -> (True when it holds); checks with no number, such as tokens
    holds: Dict[str, bool] = dataclasses.field(default_factory=dict)
    controls: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    notes: Dict = dataclasses.field(default_factory=dict)  # diagnostics, not compared
