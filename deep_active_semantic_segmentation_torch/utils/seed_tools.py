"""Seed-set tooling (own copy of the JAX package's utils/seed_tools.py
:12-36; parity: reference datasets/*/create_initial_set.py and
datasets/cityscapes/create_cluster_set.py). The sample comes from a
``random.Random`` seeded with ``seed``, so one seed gives the JAX
package's seed set."""

from __future__ import annotations

import json
import os
import random
from typing import List, Optional


def create_initial_set(keys: List[str], count: int = 50,
                       seed: Optional[int] = None) -> List[str]:
    """``count`` keys drawn without replacement (create_initial_set.py:9)."""
    rng = random.Random(seed)
    indices = rng.sample(range(len(keys)), count)
    return [keys[i] for i in indices]


def write_seed_set(path: str, keys: List[str]) -> None:
    """One key per line (str or bytes keys)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for k in keys:
            f.write((k if isinstance(k, str) else k.decode()) + "\n")


def create_cluster_set(cluster_root: str, out_path: str) -> dict:
    """{cluster: [train image paths]} from one folder of images per cluster,
    written to ``out_path`` as JSON (create_cluster_set.py:1-14)."""
    cluster_dict = {}
    for cluster in os.listdir(cluster_root):
        cluster_dict[cluster] = [
            "/leftImg8bit/train/" + f.split("_")[0] + "/" + f
            for f in os.listdir(os.path.join(cluster_root, cluster))]
    with open(out_path, "w") as f:
        f.write(json.dumps(cluster_dict))
    return cluster_dict
