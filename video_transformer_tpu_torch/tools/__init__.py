"""Offline QA tools (this package's copy of the JAX package's ``tools/validate_note.py``)."""
