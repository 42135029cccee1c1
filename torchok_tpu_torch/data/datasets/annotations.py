"""Annotation tables for the file-backed datasets: ``.csv`` through the
standard library's ``csv`` module, ``.pkl`` through pandas, which is imported
only here (the card machine has none)."""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List


def read_table(path: Path) -> Dict[str, List]:
    """Column name -> list of values (strings for a ``.csv``, the stored
    objects for a pickled DataFrame)."""
    if str(path).endswith(".csv"):
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        columns = list(rows[0]) if rows else []
        return {c: [r[c] for r in rows] for c in columns}
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(f"{path}: a .pkl annotation file needs pandas, which is not "
                          "installed; write the annotations as .csv") from e
    df = pd.read_pickle(path)
    return {c: df[c].tolist() for c in df.columns}
