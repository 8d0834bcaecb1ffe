"""Ticks of live episodes a second: every tick that an episode not yet
done stepped in the window's batches (the rollout's ``steps``; rows padded or
finished do not count), over the window's wall time."""


def read(record):
    if "window_s" not in record or "graph_ticks" not in record:
        return None
    return record["live_ticks"] / record["window_s"]
