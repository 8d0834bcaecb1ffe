"""Device ms a train step of the kernels under the frozen trunks' ranges
(TVResNet50, GNResNetEncoder): forward only, the trunks are frozen."""

from hcmbench.readers import range_ms


def read(record):
    if "window_len" not in record:
        return None
    return range_ms(record, "TVResNet50", "GNResNetEncoder")
