"""The framework logger and the metrics writer (the port's own copy of
robo_vln_tpu/utils/logging.py).

Scalars go to ``<log_dir>/metrics.jsonl``, one JSON line each with the JAX
package's fields and tags, and to TensorBoard when ``torch.utils.tensorboard``
(or tensorboardX) imports; neither is imported before a writer is made.
Videos (``VIDEO_OPTION`` "tensorboard") go to TensorBoard, their frame count
to the JSON lines.
"""

from __future__ import annotations

import json
import logging
import os
import time

logger = logging.getLogger("robo_vln_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def add_filehandler(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fh = logging.FileHandler(path)
    fh.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    logger.addHandler(fh)


def _summary_writer(log_dir: str, flush_secs: int):
    """A TensorBoard writer, or None when no TensorBoard package imports."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        try:
            from tensorboardX import SummaryWriter  # type: ignore
        except ImportError:
            return None
    return SummaryWriter(log_dir=log_dir, flush_secs=flush_secs)


class MetricsWriter:
    def __init__(self, log_dir: str, flush_secs: int = 30):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = _summary_writer(log_dir, flush_secs)

    def add_scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        self._jsonl.write(
            json.dumps({"tag": tag, "value": value, "step": int(step),
                        "ts": time.time()})
            + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_video(self, tag: str, frames, step: int, fps: int = 10) -> None:
        """A video from a list of (H, W, 3) uint8 frames (the reference's
        add_video_from_np_images); the JSON line records its frame count."""
        import numpy as np
        import torch

        self._jsonl.write(json.dumps({"tag": tag, "video_frames": len(frames),
                                      "step": int(step), "ts": time.time()}) + "\n")
        if self._tb is not None:
            video = torch.from_numpy(np.stack(frames).transpose(0, 3, 1, 2)[None])
            try:
                self._tb.add_video(tag, video, step, fps=fps)
            except Exception as e:  # noqa: BLE001 — moviepy missing: the video is skipped
                logger.warning(f"tensorboard video skipped: {e}")

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
