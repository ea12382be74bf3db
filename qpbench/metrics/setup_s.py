"""Seconds from the start of the process to the end of the warm-up call."""


def read(rec):
    return rec.setup_s
