"""The 95th percentile of the latency of every request in the window: host
clock from the call until the answer is where the entry leaves it (host
bytes, or device tensors after ``synchronize()``)."""

import numpy as np

UNIT = "ms"


def read(w):
    return float(np.percentile(np.array(w.latencies_s) * 1e3, 95)) if w.n else None
