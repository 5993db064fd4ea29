"""Global constants (own copy of the JAX package's constants.py)."""

import os

# dataset and run roots, overridable from the environment, else under the
# current directory (reference constants.py:1-3 hardcodes absolute paths)
DATASET_ROOT = os.environ.get("DASS_DATASET_ROOT", os.path.join(os.getcwd(), "datasets"))
RUNS = os.environ.get("DASS_RUNS", os.path.join(os.getcwd(), "runs"))
# the folder, beside a checkpoint, that visualize_torch.py writes its PNGs to
VISUALIZATIONS_FOLDER = os.environ.get("DASS_VISUALIZATIONS", "visualizations")

# Label value used for void / unlabeled pixels throughout
# (reference utils/cityscapes_to_lmdb.py:10).
IGNORE_INDEX = 255

# Monte-Carlo dropout hyperparameters (reference constants.py:5-6).
MC_DROPOUT_RATE = 0.25
MC_STEPS = 20
