"""Offline tools: this package's copies of the JAX package's ``tools/validate_note.py``,
``tools/add_p_params.py`` and ``tools/export_pdf.py``."""
