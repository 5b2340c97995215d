"""File readers and writers (NumPy only)."""
