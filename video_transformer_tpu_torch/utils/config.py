"""Config system: JSON + .env overlay with validated defaults.

This package's own copy of the JAX package's ``utils/config.py``, pinned to it by
the CPU parity tests (``tests/test_torch_analyzer.py``).

Keeps the reference's config surface (sections: system, proxy, downloader,
analyzer, validator, image_generator, auditor, api_keys; env key mapping;
profile defaults — reference src/utils/config.py) and adds the
``engine`` section (model size, mesh shape, decode settings).

The shipped configuration is ``config/config.yaml``, kept here as
``config.json`` (the mapping ``yaml.safe_load`` gives, written once) because
the card machine has no ``yaml``; ``load_config`` reads JSON and applies the
same defaults and environment keys as the JAX package's YAML loader.
"""

from __future__ import annotations

import os
import json
from pathlib import Path
from typing import Any

__all__ = ["load_config", "DEFAULT_CONFIG_PATH", "REQUIRED_SECTIONS"]

_REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CONFIG_PATH = Path(__file__).resolve().parent / "config.json"
DEFAULT_DOTENV_PATH = _REPO_ROOT / ".env"

REQUIRED_SECTIONS = {
    "system",
    "proxy",
    "downloader",
    "validator",
    "image_generator",
}

# Environment variables that override api_keys entries (optional cloud seams).
_ENV_KEY_MAP = {
    "VT_GEMINI_API_KEY": "gemini",
    "VT_KIMI_API_KEY": "kimi",
    "VT_NANO_BANANA_API_KEY": "nano_banana",
}


def _load_dotenv(path: Path) -> None:
    """Load KEY=VALUE lines into os.environ without overriding existing vars."""
    if not path.exists():
        return
    for line in path.read_text(encoding="utf-8").splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("#") or "=" not in stripped:
            continue
        key, value = stripped.split("=", 1)
        key, value = key.strip(), value.strip()
        if not key or key in os.environ:
            continue
        if len(value) >= 2 and value[0] == value[-1] and value[0] in {'"', "'"}:
            value = value[1:-1]
        os.environ[key] = value


def _as_dict(value: Any) -> dict[str, Any]:
    return value if isinstance(value, dict) else {}


def _as_str(value: Any, default: str) -> str:
    if isinstance(value, str) and value.strip():
        return value.strip()
    return default


def _apply_system_defaults(system: dict[str, Any]) -> None:
    """Fill profile-dependent defaults (note_profile, quality gates, render)."""
    note_profile = _as_str(system.get("note_profile"), "default").lower()
    if note_profile not in {"default", "pdf"}:
        note_profile = "default"
    system["note_profile"] = note_profile

    quality_gates = _as_dict(system.get("quality_gates"))
    quality_gates.setdefault("enabled", False)
    quality_gates.setdefault("max_extra_llm_calls", 1)
    system["quality_gates"] = quality_gates

    pdf_math = _as_dict(system.get("pdf_math"))
    pdf_math.setdefault("enable_display_math", note_profile == "pdf")
    system["pdf_math"] = pdf_math

    pdf_diagrams = _as_dict(system.get("pdf_diagrams"))
    pdf_diagrams.setdefault("enable_tikz", False)
    system["pdf_diagrams"] = pdf_diagrams

    render = _as_dict(system.get("render"))
    render.setdefault("include_concept_index", note_profile != "pdf")
    system["render"] = render

    pdf_typesetting = _as_dict(system.get("pdf_typesetting"))
    pdf_typesetting.setdefault("engine", "xelatex")
    pdf_typesetting.setdefault("mainfont", "TeX Gyre Termes")
    pdf_typesetting.setdefault("monofont", "DejaVu Sans Mono")
    pdf_typesetting.setdefault("header_tex_path", None)
    system["pdf_typesetting"] = pdf_typesetting


def _apply_engine_defaults(config: dict[str, Any]) -> None:
    """Fill defaults for the engine section (new in this build)."""
    engine = _as_dict(config.get("engine"))
    engine.setdefault("model_preset", "tiny")  # tiny / base / 7b
    engine.setdefault("dtype", "bfloat16")
    engine.setdefault("frames_per_segment", 8)
    engine.setdefault("frame_size", 256)
    engine.setdefault("max_new_tokens", 3072)
    engine.setdefault("temperature", 0.7)
    # Length-control bias toward JSON closing tokens; keeps untrained /
    # high-temperature generation within the token budget (engine.py).
    engine.setdefault("structure_bias", 1.5)
    engine.setdefault("decoding", "constrained")  # constrained / free
    engine.setdefault("checkpoint_dir", None)

    # Speculative decoding: a small distilled draft (e.g. the tiny
    # checkpoint) proposes token blocks that the serving model verifies in
    # one wide forward. Off unless a draft model_preset is set.
    draft = _as_dict(engine.get("draft"))
    draft.setdefault("model_preset", None)  # e.g. "tiny"
    draft.setdefault("checkpoint_dir", None)
    draft.setdefault("spec_tokens", 6)
    engine["draft"] = draft

    mesh = _as_dict(engine.get("mesh"))
    mesh.setdefault("data", -1)  # -1: use all remaining devices on this axis
    mesh.setdefault("model", 1)
    engine["mesh"] = mesh

    config["engine"] = engine


def load_config(path: str | Path = DEFAULT_CONFIG_PATH) -> dict[str, Any]:
    """Load and validate the framework config.

    Raises FileNotFoundError for a missing file and ValueError for a malformed
    or incomplete config.
    """
    _load_dotenv(DEFAULT_DOTENV_PATH)
    config_path = Path(path)
    if not config_path.exists():
        raise FileNotFoundError(f"Config file not found: {config_path}")

    data = json.loads(config_path.read_text(encoding="utf-8"))
    if not isinstance(data, dict):
        raise ValueError("Config must be a mapping")

    missing = REQUIRED_SECTIONS.difference(data.keys())
    if missing:
        raise ValueError(f"Config missing sections: {', '.join(sorted(missing))}")

    system = data.get("system")
    if not isinstance(system, dict):
        raise ValueError("Config system section must be a mapping")
    _apply_system_defaults(system)
    _apply_engine_defaults(data)

    api_keys = data.get("api_keys")
    if not isinstance(api_keys, dict):
        api_keys = {}
        data["api_keys"] = api_keys
    for env_name, key_name in _ENV_KEY_MAP.items():
        value = os.environ.get(env_name)
        if value:
            api_keys[key_name] = value

    return data
