"""Prompt template loading and rendering.

This package's own copy of the JAX package's ``analyzer/prompts.py``. The
templates are ``config/prompts.yaml``, kept here as ``prompts.json`` (the
same mapping, written once from the YAML) because the card machine has no
``yaml``; ``tests/test_torch_train.py`` holds the copy equal to the YAML.
Templates use str.format ``{var}`` placeholders.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Any

__all__ = ["DEFAULT_PROMPTS_PATH", "load_prompts", "render_prompt", "resolve_prompt_name"]

DEFAULT_PROMPTS_PATH = Path(__file__).resolve().parent / "prompts.json"


@functools.lru_cache(maxsize=8)
def load_prompts(path: str | Path = DEFAULT_PROMPTS_PATH) -> dict[str, str]:
    """Load the prompt-template mapping."""
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    if not isinstance(data, dict):
        raise ValueError(f"Prompts file must be a mapping: {path}")
    return {str(k): str(v) for k, v in data.items()}


def resolve_prompt_name(name: str, profile: str = "spec", path: str | Path = DEFAULT_PROMPTS_PATH) -> str:
    """Map a template name through the prompt PROFILE.

    ``spec`` serves the full behavioral spec; ``compact`` serves the short
    ``{name}_compact`` templates the distilled checkpoints were trained on,
    where such a variant exists (other templates are shared).
    """
    if profile == "compact":
        compact = f"{name}_compact"
        if compact in load_prompts(path):
            return compact
    elif profile != "spec":
        raise ValueError(f"unknown prompt profile: {profile!r}")
    return name


def render_prompt(
    name: str,
    variables: dict[str, Any] | None = None,
    path: str | Path = DEFAULT_PROMPTS_PATH,
    profile: str = "spec",
) -> str:
    """Render one template with ``{var}`` substitution; raises KeyError for
    an unknown template and for missing variables."""
    prompts = load_prompts(path)
    name = resolve_prompt_name(name, profile, path)
    if name not in prompts:
        raise KeyError(f"Unknown prompt template: {name}")
    return prompts[name].format(**(variables or {}))
