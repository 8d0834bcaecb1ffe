"""Device ms a train step under the step's optimizer range
(hier_train_step.optimizer or flat_train_step.optimizer)."""

from hcmbench.readers import range_ms


def read(record):
    if "window_len" not in record:
        return None
    return range_ms(record, "hier_train_step.optimizer", "flat_train_step.optimizer")
