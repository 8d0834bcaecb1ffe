"""Seconds from the harness's first statement to the first timed step:
building, weights, inputs, warm-up (and, in a fresh checkout, the kernels'
build)."""


def read(record):
    return record.get("setup_s")
