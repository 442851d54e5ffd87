"""Distillation training: synthetic data, the trainer and its CLI."""
