"""Output-schema grammars for constrained decoding."""
