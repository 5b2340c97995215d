"""Fusion models."""
