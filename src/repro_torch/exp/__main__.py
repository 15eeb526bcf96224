"""Print the registry-derived tables (runners + models + presets).

    PYTHONPATH=src python -m repro_torch.exp
"""
from .presets import markdown_table, models_table, runners_table

if __name__ == "__main__":
    print(runners_table())
    print()
    print(models_table())
    print()
    print(markdown_table())
