"""Print the registry-derived aggregator table.

    PYTHONPATH=src python -m repro_torch.agg [n] [f]
"""
import sys

from .registry import markdown_table

if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 18
    f = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    print(markdown_table(n, f))
