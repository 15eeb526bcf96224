"""Architecture configurations (one module per supported arch)."""
