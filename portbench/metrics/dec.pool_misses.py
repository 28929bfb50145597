"""Plan arrays allocated anew a request (`ringdecode.stats["plan_pool_misses"]`):
the pool keeps two generations of one exact shape, so a plan of another tile
count or ladder rung misses it."""

UNIT = "misses/request"
SPANS = ()


def read(w):
    n = w.stats.get("ringdecode.plan_pool_misses")
    return n / w.n if n is not None and w.n else None
