"""Core protocol pieces of the port (so far: the model attacks)."""
