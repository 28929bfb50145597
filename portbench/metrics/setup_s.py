"""Seconds from the start of ``run.py`` until the window opens: imports,
builds, the seed's data, the frozen encoder, uploads and warm-up."""

UNIT = "s"


def read(w):
    return w.setup_s
