"""Selection agreement between two AL runs (own copy of the JAX package's
utils/compare_selections.py:13-44; parity: reference
utils/compare_selections.py:4-30): for every run directory the two
experiments share, in sorted order, how many of the selections new in
that round both runs made. Returns the per-round (intersection, total)
pairs and prints one line per round.

    python -m deep_active_semantic_segmentation_torch.utils.compare_selections \\
        <experiment dir A> <experiment dir B>
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Tuple


def compare_selections(folder_a: str, folder_b: str,
                       verbose: bool = True) -> Dict[str, Tuple[int, int]]:
    list_a = [x for x in os.listdir(folder_a)
              if os.path.isdir(os.path.join(folder_a, x))]
    list_b = [x for x in os.listdir(folder_b)
              if os.path.isdir(os.path.join(folder_b, x))]
    common = sorted(x for x in list_a if x in list_b)

    last_a, last_b = set(), set()
    results = {}
    for f in common:
        with open(os.path.join(folder_a, f, "selections.txt")) as fp:
            selections_a = set(fp.readlines()).difference(last_a)
        with open(os.path.join(folder_b, f, "selections.txt")) as fp:
            selections_b = set(fp.readlines()).difference(last_b)
        last_a = last_a.union(selections_a)
        last_b = last_b.union(selections_b)
        if len(selections_b) != len(selections_a):
            raise ValueError(f"unequal number of selections in {f}")
        n = len(selections_a.intersection(selections_b))
        results[f] = (n, len(selections_a))
        if verbose:
            pct = n * 100.0 / max(len(selections_a), 1)
            print(f"Number of common elements in {f} = "
                  f"{n}/{len(selections_a)} ({pct})")
    return results


if __name__ == "__main__":
    compare_selections(sys.argv[1], sys.argv[2])
