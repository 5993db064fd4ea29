"""The per-op step tracer ``tools/trace_step_torch.py`` (the counterpart of
the JAX package's ``tools/trace_step.py``) on the CPU at toy size: every
mode prints a table whose rows parse, with positive totals; and the train
steps it builds (DeepLab-v3+/MobileNetV2 and the two-headed accuracy
predictor) are the JAX tool's steps, held against JAX steps built with
``tools/trace_step.py``'s arguments (SGD 0.9 / 5e-4, no Nesterov, constant
lr 0.01 over the lr-multiplier groups, loss weights 1.0 / 0.3) on the
same weights and batch, in f32 with dropout off and BN at its running
statistics: the loss within 1e-4 relative and the weights within 1e-3 of
the largest weight, the bars of tests/test_torch_train.py."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_active_semantic_segmentation_torch.ops import tconv_votes as tv
from deep_active_semantic_segmentation_tpu.models.accuracy_predictor import (
    DeepLabAccuracyPredictor as JaxPredictor)
from deep_active_semantic_segmentation_tpu.models.deeplab import DeepLab as JaxDeepLab
from deep_active_semantic_segmentation_tpu.models.factory import lr_multiplier_tree
from deep_active_semantic_segmentation_tpu.models.pretrained import (
    deeplab_state_dict_to_flax)
from deep_active_semantic_segmentation_tpu.ops.lr_schedule import constant_schedule
from deep_active_semantic_segmentation_tpu.parallel import optim as jx_optim
from deep_active_semantic_segmentation_tpu.parallel.steps import (
    TrainState, make_dual_train_step, make_train_step)
from tools import trace_step_torch as tool
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, predictor_state_dict_to_flax)

# FastSCNN needs ceil(side / 8) a multiple of 4, ENet and the UNet a side
# their pools halve evenly; DeepLab and the predictor take the tests' 33
SIDES = {"deeplab": 33, "dual": 33, "enet": 32, "enet_mc": 32, "fastscnn": 32,
         "unet": 32}
# train-mode BN needs two images at these sides; MC scoring runs in eval
# mode, and its 20 forwards per step are the slow part on the CPU
BATCHES = {mode: 1 if mode == "enet_mc" else 2 for mode in SIDES}
ROW = re.compile(r"^ +(\d+\.\d{3}) ms/step x(\S+) +(\S.*)$")
TOTAL = re.compile(r"^total device time (\d+\.\d{3}) ms/step over (\d+) op names; "
                   r"wall (\d+\.\d{3}) ms/step$")


@pytest.mark.parametrize("mode", tool.MODES)
def test_every_mode_prints_a_table_that_parses(mode, capsys):
    launches = tv.tconv2x_argmax_parity_major.launches
    tool.main([mode, str(SIDES[mode]), str(BATCHES[mode]), "--device", "cpu",
               "--steps", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"traced 1 steps of {mode} {SIDES[mode]}^2 bs{BATCHES[mode]} on cpu"
    total, names, wall = TOTAL.match(lines[1]).groups()
    rows = [ROW.match(line).groups() for line in lines[2:]]
    assert 0 < len(rows) <= min(int(names), tool.TOP)
    assert float(total) > 0 and float(wall) > 0
    ms = [float(r[0]) for r in rows]
    assert ms == sorted(ms, reverse=True) and sum(ms) <= float(total) + 1e-3 * len(ms)
    assert all(float(r[1]) >= 1 and r[2].strip() for r in rows)
    if mode != "enet_mc":
        assert any("backward" in r[2] for r in rows)
    # on the CPU the votes take B2's plain version: no launch
    assert tv.tconv2x_argmax_parity_major.launches == launches


class _FrozenDeepLab(JaxDeepLab):
    """The JAX DeepLab with dropout off and BN at running statistics inside
    the JAX package's own train step (which applies ``train=True``)."""

    def __call__(self, x, train=False, **kw):
        return super().__call__(x, train=False, use_dropout=False, **kw)


class _FrozenPredictor(JaxPredictor):
    def __call__(self, x, train=False, **kw):
        return super().__call__(x, train=False, use_dropout=False, **kw)


def _built(mode):
    """The tool's f32 step without dropout, BN at running statistics (its
    biases and means drawn ~0.1 N(0, 1), its scales and variances in
    [0.5, 1.5): no activation on a ReLU6 corner, where JAX's gradient
    splits ties), and the weights it starts from as JAX trees."""
    run, model, data = tool.build(mode, SIDES[mode], 2, "cpu", "float32", dropout=False)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.eval()
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
    return run, model, data, _to_flax(mode, model)


def _to_flax(mode, model):
    if mode == "dual":
        return predictor_state_dict_to_flax(model.state_dict())
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return deeplab_state_dict_to_flax(sd, "mobilenet")


@pytest.mark.parametrize("mode", ["deeplab", "dual"])
def test_the_tools_train_step_is_the_jax_tools_step(mode):
    run, model, data, (params, stats) = _built(mode)
    # tools/trace_step.py:88-105's step, in f32
    kw = dict(schedule=constant_schedule(0.01),
              lr_mults=lr_multiplier_tree(
                  params, "accuracy_predictor" if mode == "dual" else "deeplab"),
              optimizer="SGD", opt_cfg=jx_optim.SGDConfig(0.9, 5e-4, False))
    if mode == "dual":
        jstep = make_dual_train_step(_FrozenPredictor(num_classes=tool.NUM_CLASSES,
                                                      backbone="mobilenet",
                                                      output_stride=16), **kw)
    else:
        jstep = make_train_step(_FrozenDeepLab(num_classes=tool.NUM_CLASSES,
                                               backbone="mobilenet",
                                               output_stride=16), **kw)
    state = TrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                       batch_stats=stats, opt_state=jx_optim.init_opt_state(params, "SGD"),
                       step=jnp.zeros((), jnp.int32))
    batch = {"image": jnp.asarray(data["image"].numpy()),
             "label": jnp.asarray(data["label"].numpy().astype(np.float32))}
    extra = (jnp.float32(1.0), jnp.float32(0.3)) if mode == "dual" else ()
    state, metrics = jstep(state, batch, jax.random.PRNGKey(0), *extra)

    loss = float(run(0))
    ref = float(metrics["loss"])
    assert abs(loss - ref) <= 1e-4 * abs(ref), (loss, ref)
    got, _ = _to_flax(mode, model)
    jp = jax.tree_util.tree_map(np.asarray, state.params)
    scale = max(float(np.abs(x).max()) for x in jax.tree_util.tree_leaves(jp))
    err = max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - b).max()), got, jp)))
    assert err <= 1e-3 * scale, (err, scale)
    moved = max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - np.asarray(b)).max()), got, params)))
    assert moved > 100 * err, (moved, err)     # the step itself is compared
