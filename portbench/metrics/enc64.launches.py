"""Launches of the all-device encode kernel (`csrc/encode_rows.cu`) a device
encode group: the window's delta of the port's counter
`encode.stats["encode_launches"]` over that of `encode.stats["match_calls"]`
(one a group, whichever implementation ran). 1.0 says every group went
through the kernel in one launch; CPU tensors read 0.0; a port without the
counter gives None."""

UNIT = "launches/group"
SPANS = ()


def read(w):
    k, groups = w.stats.get("encode.encode_launches"), w.stats.get("encode.match_calls")
    return k / groups if k is not None and groups else None
