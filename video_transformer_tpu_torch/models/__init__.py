"""Model stack: video ViT encoder + decoder-only LM = VideoLM (PyTorch)."""
