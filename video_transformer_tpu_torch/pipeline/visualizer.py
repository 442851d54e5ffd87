"""Blueprint image generation.

The reference submits the schema to a cloud diffusion relay and polls for the
result (image_generator.py:144-268). The TPU-native default is a **local
deterministic diagram renderer**: the visual schema text is parsed into
nodes/edges and drawn in a paper style — zero network, instant, and
auditable. The grsai relay remains available as an optional backend for
deployments that want diffusion-rendered art (backend: "grsai" + api key).

This package's own copy of the JAX package's ``pipeline/visualizer.py``
(``parse_schema_graph`` and ``_layout_nodes`` unchanged). The JAX renderer
draws with PIL and the DejaVu fonts; the port imports no PIL and the card
has no DejaVu font, so this one draws the same figure with ``raster.py``
(PIL's primitives in numpy, text from a glyph atlas of DejaVu) and writes
and checks the PNG with ``png.py``.
``tests/test_torch_visualizer.py`` holds the decoded image against JAX's
within a stated share of pixels.
"""

from __future__ import annotations

import logging
import math
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

from .png import decode_png, encode_png
from .raster import Canvas, load_face

__all__ = ["ImageGenerationConfig", "ImageGenerator", "parse_schema_graph"]

_ARROW_RE = re.compile(r"\s*(?:->|→|=>|—>)\s*")
_BULLET_RE = re.compile(r"^\s*[-*+•]\s*")

# Paper-style palette.
_BG = (250, 248, 243)
_INK = (40, 40, 46)
_BOX_FILL = (255, 255, 255)
_BOX_EDGE = (90, 90, 110)
_ACCENT = (176, 100, 60)


@dataclass
class ImageGenerationConfig:
    style: str = "paper"
    backend: str = "local"  # local | grsai
    model: str = "nano-banana-pro"
    aspect_ratio: str = "16:9"
    image_size: str = "1K"
    format: str = "png"
    quality: int = 95
    poll_interval: float = 3.0
    poll_timeout: float = 180.0


def _layout_nodes(
    nodes: list[str],
    edges: list[tuple[str, str]],
    width: int,
    height: int,
    margin: int,
    top: int,
) -> tuple[dict[str, tuple[float, float]], float, float]:
    """Node positions: layered left-to-right by edge depth when the schema
    has flow structure, square grid otherwise. Returns (centers, box_w, box_h).
    """
    depth: dict[str, int] = {}
    if edges:
        # Longest-path layering (cycle-guarded by a fixed iteration count).
        for node in nodes:
            depth[node] = 0
        for _ in range(len(nodes)):
            changed = False
            for src, dst in edges:
                if src in depth and dst in depth and depth[dst] < depth[src] + 1:
                    depth[dst] = depth[src] + 1
                    changed = True
            if not changed:
                break

    centers: dict[str, tuple[float, float]] = {}
    if edges and len(set(depth.values())) > 1:
        layers: dict[int, list[str]] = {}
        for node in nodes:
            layers.setdefault(depth.get(node, 0), []).append(node)
        num_layers = max(layers) + 1
        cell_w = (width - 2 * margin) / num_layers
        tallest = max(len(members) for members in layers.values())
        cell_h = (height - top - margin) / max(tallest, 1)
        box_w = cell_w * 0.82
        box_h = min(cell_h * 0.6, height / 7)
        for layer, members in layers.items():
            span = (height - top - margin) / (len(members) + 1)
            for i, node in enumerate(members, 1):
                cx = margin + (layer + 0.5) * cell_w
                cy = top + i * span
                centers[node] = (cx, cy)
    else:
        columns = min(4, max(1, round(len(nodes) ** 0.5)))
        rows = (len(nodes) + columns - 1) // columns
        cell_w = (width - 2 * margin) / columns
        cell_h = (height - top - margin) / max(rows, 1)
        box_w = cell_w * 0.82
        box_h = min(cell_h * 0.55, height / 7)
        for idx, node in enumerate(nodes):
            row, col = divmod(idx, columns)
            centers[node] = (
                margin + (col + 0.5) * cell_w,
                top + (row + 0.5) * cell_h,
            )
    return centers, box_w, box_h


def parse_schema_graph(schema: str) -> tuple[str, list[str], list[tuple[str, str]]]:
    """Parse free-form schema text into (title, nodes, edges).

    Lines with arrows become edge chains ("A -> B -> C"); other non-empty
    lines become standalone nodes; the first line is the title when it has
    no arrow.
    """
    lines = [ln.strip() for ln in schema.splitlines() if ln.strip()]
    title = ""
    nodes: list[str] = []
    edges: list[tuple[str, str]] = []
    seen: set[str] = set()

    def add_node(name: str) -> None:
        name = _BULLET_RE.sub("", name).strip()[:40]
        if name and name not in seen:
            seen.add(name)
            nodes.append(name)

    body = lines
    if lines and not _ARROW_RE.search(lines[0]):
        title = lines[0][:60]
        body = lines[1:]
    if not body:
        body = lines

    for line in body:
        parts = [p for p in _ARROW_RE.split(line) if p.strip()]
        if len(parts) >= 2:
            for src, dst in zip(parts, parts[1:]):
                add_node(src)
                add_node(dst)
                edges.append(
                    (
                        _BULLET_RE.sub("", src).strip()[:40],
                        _BULLET_RE.sub("", dst).strip()[:40],
                    )
                )
        else:
            add_node(line)
    return title, nodes, edges


class ImageGenerator:
    def __init__(self, config: dict[str, Any], logger: logging.Logger | None = None):
        self.logger = logger or logging.getLogger("video_transformer")
        raw = config.get("image_generator", {}) or {}
        self.generation_config = ImageGenerationConfig(
            style=raw.get("style", "paper"),
            backend=raw.get("backend", "local"),
            model=raw.get("model", "nano-banana-pro"),
            aspect_ratio=raw.get("aspect_ratio", "16:9"),
            image_size=raw.get("image_size", "1K"),
            format=raw.get("format", "png"),
            quality=int(raw.get("quality", 95)),
            poll_interval=float(raw.get("poll_interval", 3)),
            poll_timeout=float(raw.get("poll_timeout", 180)),
        )
        self.api_key = (config.get("api_keys", {}) or {}).get("nano_banana", "")
        self.grsai_base_url = (config.get("grsai", {}) or {}).get(
            "base_url", "https://grsai.dakka.com.cn"
        )

    # -- public API ----------------------------------------------------------

    def generate_blueprint(self, mind_map_structure: str) -> bytes | None:
        """Render the schema to PNG bytes; None/raise on failure."""
        if not mind_map_structure or not mind_map_structure.strip():
            return None
        backend = self.generation_config.backend
        if backend == "grsai" and self.api_key:
            data = self._grsai_render(mind_map_structure)
        else:
            data = self._local_render(mind_map_structure)
        if data and self._validate_image(data):
            return data
        return None

    def save_image(self, image_data: bytes, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(image_data)

    def _validate_image(self, data: bytes) -> bool:
        """Decodable and at least 100x100 px (reference image_generator.py:270)."""
        try:
            height, width = decode_png(data).shape[:2]
        except ValueError:
            return False
        return width >= 100 and height >= 100

    # -- local renderer --------------------------------------------------------

    def _canvas_size(self) -> tuple[int, int]:
        sizes = {"1K": 1280, "2K": 2048, "4K": 3840}
        width = sizes.get(self.generation_config.image_size, 1280)
        ratio = self.generation_config.aspect_ratio
        try:
            num, den = ratio.split(":")
            height = int(width * int(den) / int(num))
        except (ValueError, ZeroDivisionError):
            height = int(width * 9 / 16)
        return width, height

    def _local_render(self, schema: str) -> bytes:
        width, height = self._canvas_size()
        title, nodes, edges = parse_schema_graph(schema)
        canvas = Canvas(width, height, _BG)
        font_title = load_face("bold", width // 36)
        font_node = load_face("regular", width // 56)

        margin = width // 24
        if title:
            canvas.text((margin, margin // 2), title, font_title, _INK)
            canvas.line(
                [(margin, margin + width // 30), (width - margin, margin + width // 30)],
                _ACCENT,
                3,
            )

        if not nodes:
            nodes = ["(empty schema)"]

        top = margin * 2 + (width // 30 if title else 0)
        centers, box_w, box_h = _layout_nodes(
            nodes, edges, width, height, margin, top
        )

        # Edges first (under boxes).
        for src, dst in edges:
            if src in centers and dst in centers:
                x1, y1 = centers[src]
                x2, y2 = centers[dst]
                canvas.line([(x1, y1), (x2, y2)], _ACCENT, 3)
                # Arrowhead.
                angle = math.atan2(y2 - y1, x2 - x1)
                ah = width // 90
                for rot in (0.5, -0.5):
                    canvas.line(
                        [
                            (x2, y2),
                            (
                                x2 - ah * math.cos(angle + rot),
                                y2 - ah * math.sin(angle + rot),
                            ),
                        ],
                        _ACCENT,
                        3,
                    )

        for node, (cx, cy) in centers.items():
            box = [cx - box_w / 2, cy - box_h / 2, cx + box_w / 2, cy + box_h / 2]
            canvas.rounded_rectangle(box, int(box_h / 5), _BOX_FILL, _BOX_EDGE, 3)
            text = node if len(node) <= 24 else node[:23] + "…"
            bbox = canvas.textbbox((0, 0), text, font_node)
            tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
            canvas.text((cx - tw / 2, cy - th / 2 - bbox[1]), text, font_node, _INK)

        return encode_png(canvas.pixels)

    # -- optional grsai backend --------------------------------------------------

    def _grsai_render(self, schema: str) -> bytes | None:
        """Async submit + poll against the grsai relay (reference
        image_generator.py:144-268). Requires network + api key."""
        import requests

        config = self.generation_config
        submit_url = f"{self.grsai_base_url.rstrip('/')}/v1/draw/nano-banana"
        headers = {"Authorization": f"Bearer {self.api_key}"}
        payload = {
            "model": config.model,
            "prompt": schema,
            "aspectRatio": config.aspect_ratio,
            "imageSize": config.image_size,
        }
        resp = requests.post(submit_url, json=payload, headers=headers, timeout=30)
        resp.raise_for_status()
        task_id = resp.json().get("data", {}).get("id") or resp.json().get("id")
        if not task_id:
            raise RuntimeError("grsai submit returned no task id")

        poll_url = f"{self.grsai_base_url.rstrip('/')}/v1/draw/result"
        deadline = time.monotonic() + config.poll_timeout
        while time.monotonic() < deadline:
            time.sleep(config.poll_interval)
            result = requests.post(
                poll_url, json={"id": task_id}, headers=headers, timeout=30
            ).json()
            status = result.get("data", {}).get("status") or result.get("status")
            self.logger.info(f"event=grsai_poll task={task_id} status={status}")
            if status == "succeeded":
                results = result.get("data", {}).get("results") or []
                url = results[0].get("url") if results else None
                if not url:
                    raise RuntimeError("grsai succeeded without image url")
                download = requests.get(url, timeout=60)
                download.raise_for_status()
                return download.content
            if status == "failed":
                raise RuntimeError("grsai render failed")
        raise RuntimeError("grsai render timeout")
