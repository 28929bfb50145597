"""Launches of the resident decode kernel (`csrc/resident_decode.cu`) a
`decode_step`: the window's delta of the port's counter
`ringdecode.stats["resident_launches"]` over the requests. 1.0 says every step
went through the kernel, one launch a group of rows; a port without the
counter gives None."""

UNIT = "launches/batch"
SPANS = ()


def read(w):
    k = w.stats.get("ringdecode.resident_launches")
    return k / w.n if k is not None and w.n else None
