"""Videos, the top-down map tile and the attention heatmap of the eval
(the port's own copy of robo_vln_tpu/tasks/viz.py, and of the JAX
evaluator's ``_save_attention_plot``).

Frames (:func:`observations_to_image`: rgb, depth and the top-down map
tile, the agent drawn in), the instruction overlay and the mp4 writer keep
the JAX package's lazy ``cv2`` import: the same dependency for the same
keys, so ``get_config`` refuses ``VIDEO_OPTION`` and the ``TOP_DOWN_MAP``
measure where OpenCV is missing.  The attention heatmap needs no OpenCV:
:data:`VIRIDIS_BGR` is cv2's ``COLORMAP_VIRIDIS`` as a 256x3 table, and
:func:`write_png` writes the PNG with ``zlib`` and ``struct``; a file it
writes reads back (``cv2.imread``) equal to the one ``cv2.imwrite``
writes from the same pixels.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional

import numpy as np

# cv2.applyColorMap(arange(256), COLORMAP_VIRIDIS), (B, G, R) per level
VIRIDIS_BGR = np.frombuffer(bytes.fromhex(
    "5401445602445704455905455a07465c08465d0a465e0b46600d47610e47631047641147"
    "6513476714486816486917486a18486c1a486d1b486e1c486f1d48701f48712048732148"
    "7423487524487625487726487828487929487a2a477a2c477b2d477c2e477d2f477e3046"
    "7e32467f3346803446813545813745823845833944833a44843b44843d43853e43853f42"
    "86404286414287424187444188454088464088473f89483f89493e894a3e8a4c3e8a4d3d"
    "8a4e3d8a4f3c8b503c8b513b8b523b8b533a8c543a8c55398c56398c58388c59388c5a37"
    "8d5b378d5c368d5d368d5e358d5f358d60348d61348d62338d63338e64328e65328e6631"
    "8e67318e68318e69308e6a308e6b2f8e6c2f8e6d2e8e6e2e8e6f2e8e702d8e712d8e712c"
    "8e722c8e732c8e742b8e752b8e762a8e772a8e782a8e79298e7a298e7b298e7c288e7d28"
    "8e7e278e7f278e80278e81268e82268e82268e83258e84258e85258e86248e87248e8823"
    "8e89238d8a238d8b228d8c228d8d228d8e218d8f218d90218c91218c92208c92208c9320"
    "8c941f8b951f8b961f8b971f8b981f8a991f8a9a1f8a9b1e899c1e899d1e899e1f889f1f"
    "88a01f88a11f87a11f87a21f86a32086a42085a52185a62185a72284a82283a92383aa24"
    "82ab2582ac2581ad2681ad2780ae287faf297fb02a7eb12c7db22d7cb32e7cb42f7bb531"
    "7ab63279b63479b73578b83777b93876ba3a75bb3b74bc3d73bc3f72bd4071be4270bf44"
    "6fc0466ec1486dc14a6cc24c6bc34e6ac45069c55268c55467c65665c75864c85a63c85c"
    "62c95e60ca605fcb635ecb655ccc675bcd695acd6c58ce6e57cf7056d07354d07553d177"
    "51d17a50d27c4ed37f4dd3814bd48449d58648d58946d68b45d68e43d79041d79340d895"
    "3ed8983cd99b3bd99d39daa037daa236dba534dba832dcaa30dcad2fddb02dddb22bdeb5"
    "29deb828deba26dfbd25dfc023dfc221e0c520e0c81fe1ca1de1cd1ce1d01be2d21ae2d5"
    "19e2d819e3da18e3dd18e3df18e4e219e4e519e4e71ae5ea1be5ec1ce5ef1de5f11ee6f4"
    "20e6f621e6f823e7fb25e7fd"
), np.uint8).reshape(256, 3)


def draw_agent(image: np.ndarray, coord, angle: float,
               radius_px: int) -> np.ndarray:
    """Draw the agent as a filled circle + heading tick (stand-in for
    habitat maps.draw_agent, used by reference utils.py:48-54)."""
    import cv2

    r, c = int(coord[0]), int(coord[1])
    cv2.circle(image, (c, r), max(radius_px, 2), (40, 40, 40), -1)
    tip = (
        int(c + 2 * radius_px * np.sin(angle)),
        int(r - 2 * radius_px * np.cos(angle)),
    )
    cv2.line(image, (c, r), tip, (40, 40, 40), max(radius_px // 2, 1))
    return image


def topdown_map_tile(info: Dict, height: int) -> Optional[np.ndarray]:
    """Colorized top-down map scaled to the egocentric view height
    (reference observations_to_image, habitat_extensions/utils.py:44-70)."""
    import cv2

    td = info.get("top_down_map") if info else None
    if not td:
        return None
    top_down_map = np.array(td["map"], copy=True)
    top_down_map = draw_agent(
        top_down_map, td["agent_map_coord"], td.get("agent_angle", 0.0),
        radius_px=top_down_map.shape[0] // 16,
    )
    if top_down_map.shape[0] > top_down_map.shape[1]:
        top_down_map = np.rot90(top_down_map, 1).copy()
    old_h, old_w, _ = top_down_map.shape
    width = int(float(height) / old_h * old_w)
    return cv2.resize(
        top_down_map, (width, height), interpolation=cv2.INTER_CUBIC
    )


def observations_to_image(observation: Dict, info: Optional[Dict] = None) -> np.ndarray:
    """Tile rgb + resized depth (+ top-down map when measured) into one frame."""
    import cv2

    views = []
    size = -1
    if "rgb" in observation:
        rgb = np.asarray(observation["rgb"])[..., :3].astype(np.uint8)
        size = rgb.shape[0]
        views.append(rgb)
    if "depth" in observation:
        depth = np.asarray(observation["depth"]).squeeze()
        if size == -1:
            size = depth.shape[0]
        dm = (np.clip(depth, 0, 1) * 255).astype(np.uint8)
        dm = np.stack([dm] * 3, axis=2)
        dm = cv2.resize(dm, (size, size), interpolation=cv2.INTER_CUBIC)
        views.append(dm)
    assert views, "need at least one visual sensor"
    frame = np.concatenate(views, axis=1)
    map_tile = topdown_map_tile(info, frame.shape[0])
    if map_tile is not None:
        frame = np.concatenate([frame, map_tile], axis=1)
    return frame


def append_text_to_image(image: np.ndarray, text: str) -> np.ndarray:
    import cv2

    h, w = image.shape[:2]
    pad = 50
    canvas = np.zeros((h + pad, w, 3), np.uint8)
    canvas[:h] = image
    cv2.putText(
        canvas, text[:80], (5, h + 30), cv2.FONT_HERSHEY_SIMPLEX, 0.4,
        (255, 255, 255), 1,
    )
    return canvas


def images_to_video(images: List[np.ndarray], output_dir: str, video_name: str,
                    fps: int = 30) -> str:
    import cv2

    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"{video_name}.mp4")
    h, w = images[0].shape[:2]
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), max(fps, 1), (w, h)
    )
    for im in images:
        writer.write(cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    writer.release()
    return path


def generate_video(video_option: List[str], video_dir: str,
                   images: List[np.ndarray], episode_id, checkpoint_idx: int,
                   metrics: Dict[str, float], tb_writer=None, fps: int = 30):
    """Both reference VIDEO_OPTION branches (habitat generate_video): "disk"
    writes an mp4, "tensorboard" logs the frames through the writer."""
    if not video_option or not images:
        return
    metric_str = "-".join(f"{k}={v:.2f}" for k, v in metrics.items())
    name = f"episode={episode_id}-ckpt={checkpoint_idx}-{metric_str}"
    if "disk" in video_option:
        images_to_video(images, video_dir, name, fps=fps)
    if "tensorboard" in video_option and tb_writer is not None:
        tb_writer.add_video(
            f"episode{episode_id}", images, checkpoint_idx, fps=min(fps, 10)
        )


def write_png(path: str, image_bgr: np.ndarray) -> None:
    """An (H, W, 3) uint8 image in cv2's (B, G, R) order as an 8-bit RGB
    PNG: one IDAT of the filter-0 rows, no other chunk."""
    h, w, _ = image_bgr.shape
    rows = np.ascontiguousarray(image_bgr[..., ::-1])
    raw = b"".join(b"\x00" + rows[r].tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def attention_heatmap(salience: np.ndarray) -> np.ndarray:
    """(T, L) instruction-token salience -> the (B, G, R) heatmap the JAX
    evaluator writes: min-max scaled to 0..255, colored by viridis, each
    cell scaled up to max(1, 256 // max(T, L)) pixels a side."""
    s = salience - salience.min()
    s = s / max(float(s.max()), 1e-8)
    img = VIRIDIS_BGR[(s * 255).astype(np.uint8)]
    scale = max(1, 256 // max(img.shape[0], img.shape[1]))
    return np.kron(img, np.ones((scale, scale, 1), np.uint8))


def save_attention_plot(salience: np.ndarray, episode_id, video_dir: str,
                        checkpoint_index: int) -> str:
    """The episode's heatmap PNG under ``VIDEO_DIR/attention/`` (the JAX
    evaluator's ``_save_attention_plot``); returns its path."""
    out_dir = os.path.join(video_dir or "videos", "attention")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"attention_ep{episode_id}_ckpt{checkpoint_index}.png")
    write_png(path, attention_heatmap(salience))
    return path
