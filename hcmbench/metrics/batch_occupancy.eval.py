"""Live episode ticks over the batch times the ticks stepped (each batch
runs until its last episode ends), in %: the rows a tick computes for
episodes still running."""


def read(record):
    if "graph_ticks" not in record or not record.get("ticks_stepped"):
        return None
    return 100.0 * record["live_ticks"] / (record["batch"] * record["ticks_stepped"])
