"""Frames trained a second: every frame of the window's steps (B × T on each
data rank) over the window's wall time, which ends in a synchronisation."""


def read(record):
    if "window_s" not in record:
        return None
    frames = record["steps"] * record["rows"] * record["window_len"] * record["ranks"]
    return frames / record["window_s"]
