"""Markdown -> PDF export via pandoc (optional host dependency).

This package's own copy of the JAX package's ``tools/export_pdf.py`` (see
docs/pdf-export.md). Typesetting options come from the config's
``system.pdf_typesetting`` section, read from the port's JSON config
(``utils/config.py``); a missing pandoc or xelatex gives a clear error
instead of a traceback. Nothing is installed.

CLI: python -m video_transformer_tpu_torch.tools.export_pdf NOTE.md -o NOTE.pdf [--config my.json]
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Any

__all__ = ["export_pdf", "main"]


def export_pdf(
    markdown_path: str | Path,
    output_path: str | Path,
    typesetting: dict[str, Any] | None = None,
    timeout: float = 300.0,
) -> Path:
    """Render one note to PDF. Raises RuntimeError when pandoc is missing
    or fails."""
    if shutil.which("pandoc") is None:
        raise RuntimeError(
            "pandoc is not installed; PDF export is optional — the Markdown "
            "note is the primary artifact"
        )
    settings = dict(typesetting or {})
    engine = settings.get("engine", "xelatex")
    cmd = [
        "pandoc",
        str(markdown_path),
        "-o",
        str(output_path),
        f"--pdf-engine={engine}",
        "-V",
        f"mainfont={settings.get('mainfont', 'TeX Gyre Termes')}",
        "-V",
        f"monofont={settings.get('monofont', 'DejaVu Sans Mono')}",
        "--from",
        "markdown+raw_attribute+tex_math_dollars",
    ]
    header = settings.get("header_tex_path")
    if header and Path(header).exists():
        cmd += ["-H", str(header)]

    result = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if result.returncode != 0:
        raise RuntimeError(f"pandoc failed: {result.stderr[-800:]}")
    out = Path(output_path)
    if not out.exists():
        raise RuntimeError("pandoc reported success but produced no PDF")
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="export a note to PDF")
    parser.add_argument("input")
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--config", help="the port's JSON config (utils/config.json shape) for pdf_typesetting")
    args = parser.parse_args(argv)

    typesetting: dict[str, Any] = {}
    if args.config:
        from ..utils.config import load_config

        typesetting = (
            load_config(args.config).get("system", {}).get("pdf_typesetting", {})
        )
    try:
        out = export_pdf(args.input, args.output, typesetting)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
