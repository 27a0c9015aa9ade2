"""Host packet batching (numpy copy of ``repro.data.pipeline.phv_batches``):
chunks a packet trace into fixed-size batches for the feature pipeline (the
switch->server record channel)."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def phv_batches(trace: Dict[str, np.ndarray], batch: int
                ) -> Iterator[Dict[str, np.ndarray]]:
    n = len(trace["ts"])
    for i in range(0, n, batch):
        yield {k: v[i:i + batch] for k, v in trace.items()}
