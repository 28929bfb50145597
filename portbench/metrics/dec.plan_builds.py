"""Native plan builds a request (`ringdecode.stats["plan_builds"]`): one a
frame body, more where the NFMAX ladder rebuilt a plan that overflowed its
record capacity."""

UNIT = "builds/request"
SPANS = ()


def read(w):
    n = w.stats.get("ringdecode.plan_builds")
    return n / w.n if n is not None and w.n else None
