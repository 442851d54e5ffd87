"""Rewrite a URL list appending per-line part numbers (?p=N).

Multi-part Bilibili series share one BV id; processing each part needs an
explicit ``p`` parameter. This tool appends ``p={line_number}`` to every URL
in a list file (this package's own copy of the JAX package's
``tools/add_p_params.py``).

CLI: python -m video_transformer_tpu_torch.tools.add_p_params URL.txt [-o OUT]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

__all__ = ["add_part_numbers", "main"]


def add_part_numbers(lines: list[str], start: int = 1) -> list[str]:
    """Line-number semantics: part N = position in the file (1-based)."""
    out: list[str] = []
    for offset, line in enumerate(lines):
        part = start + offset
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            out.append(line)
            continue
        if "p=" in stripped.split("?")[-1]:
            out.append(stripped)  # already has a part number
            continue
        separator = "&" if "?" in stripped else "?"
        out.append(f"{stripped}{separator}p={part}")
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="append p=N part params")
    parser.add_argument("input")
    parser.add_argument("-o", "--output", help="default: rewrite in place")
    parser.add_argument("--start", type=int, default=1)
    args = parser.parse_args(argv)

    path = Path(args.input)
    lines = path.read_text(encoding="utf-8").splitlines()
    rewritten = add_part_numbers(lines, start=args.start)
    target = Path(args.output) if args.output else path
    target.write_text("\n".join(rewritten) + "\n", encoding="utf-8")
    print(f"wrote {target}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
