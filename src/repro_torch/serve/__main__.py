"""``python -m repro_torch.serve`` — print the quorum-read table."""
from .quorum import markdown_table

if __name__ == "__main__":
    print(markdown_table())
