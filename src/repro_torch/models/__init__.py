"""Model zoo of the port (so far: the dense transformer, inference half)."""
