"""Seconds from the process start to the first timed batch or step."""


def read(rec):
    return rec["setup_s"]
