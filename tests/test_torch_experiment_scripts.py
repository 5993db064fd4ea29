"""The experiment scripts (test_scripts/*.sh) through the port's drivers:
every `python` command line is parsed by its `_torch` driver's own parser
(`active_train_torch.py` through the port's `config.parse_cli`,
`accuracy_predictor_train_torch.parse_args`), finalized for one rank and
held field for field against the JAX package's configuration of the same
command (`tests/test_experiment_scripts.py`'s parser), and passed by the
port's checks that run before any training (`engine.active_loop.check_args`,
`accuracy_predictor_train_torch.check_mode`). Parse-only: nothing trains."""

import argparse
import dataclasses
import glob
import os
import random
import shlex

import pytest

import accuracy_predictor_train_torch
from deep_active_semantic_segmentation_torch import config as pt_config
from deep_active_semantic_segmentation_torch.engine.active_loop import check_args
from deep_active_semantic_segmentation_tpu import config as jx_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(glob.glob(os.path.join(REPO, "test_scripts", "*.sh")))


def _commands():
    """(script, argv) per `python` line, continuations joined."""
    out = []
    for path in SCRIPTS:
        with open(path) as f:
            text = f.read().replace("\\\n", " ")
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("python "):
                out.append((os.path.basename(path), shlex.split(line)))
    return out


COMMANDS = _commands()


def _jax_config(driver, argv):
    """The JAX package's configuration of a command, built as
    tests/test_experiment_scripts.py builds it."""
    parser = argparse.ArgumentParser()
    accuracy = driver == "accuracy_predictor_train.py"
    jx_config.add_common_flags(parser, selection_choices=(
        list(accuracy_predictor_train_torch.MODES) if accuracy else None))
    if accuracy:
        parser.add_argument("--weight-unet", type=float, default=0.30)
        parser.add_argument("--weight-wrong-label-unet", type=float, default=0.75)
        parser.add_argument("--accuracy-selection", type=str, default="softmax")
        parser.add_argument("--no-end-to-end", action="store_true")
        parser.add_argument("--symmetry", action="store_true")
    return jx_config.config_from_args(parser.parse_args(argv))


def test_the_scripts_hold_29_commands():
    assert len(SCRIPTS) == 16 and len(COMMANDS) == 29


@pytest.mark.parametrize("script,cmd", COMMANDS,
                         ids=[f"{s}:{i}:{c[1]}" for i, (s, c) in enumerate(COMMANDS)])
def test_script_command_through_the_port_driver(script, cmd):
    driver, argv = cmd[1], cmd[2:]
    assert driver in ("active_train.py", "accuracy_predictor_train.py"), cmd
    if driver == "active_train.py":
        got = pt_config.parse_cli(argv)
    else:
        got = accuracy_predictor_train_torch.parse_args(argv)
    ref = _jax_config(driver, argv)
    random.seed(0)
    ref = ref.finalize(n_devices=1)
    random.seed(0)
    got = got.finalize(n_devices=1)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref), script
    # the port's checks before training accept the command
    if driver == "active_train.py":
        check_args(got, 1)
    else:
        accuracy_predictor_train_torch.check_mode(got.active_selection_mode, got.dataset)
