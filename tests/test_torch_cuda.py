"""Tests of the port that run only on an NVIDIA card: its CUDA kernels,
and its train and eval steps with their state on the card.

Each is marked ``cuda`` and skips, with a reason, where torch finds no
card. This file imports neither JAX nor the JAX package, so it also runs
on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from deep_active_semantic_segmentation_torch.ops import tconv_votes as tv
from deep_active_semantic_segmentation_torch.ops import upsample_argmax as ua
from deep_active_semantic_segmentation_torch.selection import kernels


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import, so every pytest worker
    collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 19, 129, 129), (3, 21, 17, 33),
                                   (1, 19, 129, 129), (2, 7, 1, 5),
                                   # tile edges: h, w off the 4 x 32 tile, h = w = 2,
                                   # a 67-wide row (268 B, not 16-byte aligned),
                                   # more classes than one staged chunk
                                   (2, 19, 2, 2), (1, 19, 130, 67), (1, 40, 9, 35)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample4_argmax_kernel_equals_plain(cuda_device, shape, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = torch.randn(shape, device=cuda_device, generator=gen).to(dtype)
    before = ua.upsample4_argmax.launches
    votes = ua.upsample4_argmax(x)
    torch.cuda.synchronize()
    assert ua.upsample4_argmax.launches == before + 1
    # the kernel rounds each product and sum once, as the plain version
    # does, so the votes agree exactly
    assert torch.equal(votes, ua.upsample4_argmax_plain(x))


@pytest.mark.cuda
def test_upsample4_argmax_kernel_rejects_strided_input(cuda_device):
    x = torch.zeros(2, 19, 17, 17, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ua.upsample4_argmax(x.transpose(2, 3))


@pytest.mark.cuda
def test_mc_sweep_launches_the_kernel_every_step(cuda_device):
    from deep_active_semantic_segmentation_torch.models.factory import build_model

    model = build_model("deeplab", 19, mc_dropout=True, device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    images = torch.randint(0, 256, (2, 65, 65, 3), dtype=torch.uint8,
                           device=cuda_device, generator=gen.manual_seed(0))
    labels = torch.zeros(2, 65, 65, dtype=torch.uint8, device=cuda_device)
    maps = {}
    for fused in (True, False):
        before = ua.upsample4_argmax.launches
        maps[fused] = kernels.mc_vote_entropy_maps(
            model, images, labels, kernels.mc_generator(0, 0, cuda_device),
            19, 6, fused_upsample=fused)
        assert ua.upsample4_argmax.launches - before == (6 if fused else 0)
    assert (maps[True] - maps[False]).abs().mean().item() < 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", [((8, 16, 256, 256), 19), ((3, 16, 33, 47), 19),
                                        ((1, 16, 1, 5), 19), ((2, 8, 9, 7), 21),
                                        # tile edges: h, w off the 4 x 16 tile, one
                                        # pixel, a 129-wide row (not 16-byte aligned),
                                        # Cin off the 8-channel chunk, 32 classes
                                        ((2, 16, 65, 129), 19), ((1, 16, 1, 1), 19),
                                        ((2, 13, 6, 40), 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tconv2x_argmax_kernel_equals_plain(cuda_device, shape, cout, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape) + cout)
    x = torch.randn(shape, device=cuda_device, generator=gen).to(dtype)
    weight = (torch.randn((shape[1], cout, 3, 3), device=cuda_device,
                          generator=gen) / shape[1] ** 0.5).to(dtype)
    before = tv.tconv2x_argmax_parity_major.launches
    votes = tv.tconv2x_argmax_parity_major(x, weight)
    torch.cuda.synchronize()
    assert tv.tconv2x_argmax_parity_major.launches == before + 1
    assert votes.shape == (shape[0], 4) + shape[2:] and votes.dtype == torch.int32
    # three TF32 passes (two for bf16) on the tensor cores: f32-level
    # logits in another order, so the bar, not bit equality: >= 99.5% of
    # votes equal, and all where the vote is decided
    full = torch.nn.functional.conv_transpose2d(
        x.double(), weight.double(), stride=2, padding=1, output_padding=1)
    same = (tv.interleave_parity_major(votes) == tv.interleave_parity_major(
        tv.tconv2x_argmax_parity_major_plain(x, weight)))
    assert same.float().mean().item() >= 0.995
    assert same[tv.confident_votes(full, str(dtype).split(".")[1])].all()


@pytest.mark.cuda
def test_tconv2x_argmax_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(2, 16, 17, 17, device=cuda_device)
    weight = torch.zeros(16, 19, 3, 3, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tv.tconv2x_argmax_parity_major(x.transpose(2, 3), weight)
    with pytest.raises(ValueError, match="Cin <= 32"):
        tv.tconv2x_argmax_parity_major(torch.zeros(1, 40, 4, 4, device=cuda_device),
                                       torch.zeros(40, 19, 3, 3, device=cuda_device))
    with pytest.raises(ValueError, match="weight on"):
        tv.tconv2x_argmax_parity_major(x, weight.cpu())


@pytest.mark.cuda
def test_enet_mc_sweep_launches_the_kernel_every_step(cuda_device):
    from deep_active_semantic_segmentation_torch.models.factory import build_model

    model = build_model("enet", 19, device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           device=cuda_device, generator=gen.manual_seed(0))
    labels = torch.zeros(2, 64, 64, dtype=torch.uint8, device=cuda_device)
    maps = {}
    for fused in (True, False):
        before = tv.tconv2x_argmax_parity_major.launches
        maps[fused] = kernels.mc_vote_entropy_maps(
            model, images, labels, kernels.mc_generator(0, 0, cuda_device),
            19, 6, fused_upsample=fused)
        assert tv.tconv2x_argmax_parity_major.launches - before == (6 if fused else 0)
    assert maps[True].shape == (2, 64, 64)
    assert (maps[True] - maps[False]).abs().mean().item() < 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_and_eval_steps_run_on_the_card(cuda_device, dtype):
    """A train step and an eval step with the model, optimizer state,
    batch and every result on the card."""
    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import make_schedule
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_eval_step, make_train_step)

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = build_model("deeplab", 19, mc_dropout=True, device=cuda_device,
                        generator=gen).train()
    opt = build_optimizer("SGD", param_groups(model, "deeplab"))
    cw = torch.rand(19, device=cuda_device, generator=gen) + 0.5
    step = make_train_step(model, opt, build_loss("ce", class_weights=cw),
                           make_schedule("poly", 0.01, 2, 3), compute_dtype=dtype,
                           generator=gen)
    batch = {"image": torch.randint(0, 256, (2, 65, 65, 3), dtype=torch.uint8,
                                    device=cuda_device, generator=gen),
             "label": torch.randint(0, 19, (2, 65, 65), dtype=torch.uint8,
                                    device=cuda_device, generator=gen)}
    out = step(batch, 0)
    assert out["loss"].device.type == "cuda" and torch.isfinite(out["loss"])
    assert all(st["momentum_buffer"].device.type == "cuda"
               for st in opt.state.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    ev = make_eval_step(model, 19, build_loss("ce", class_weights=cw,
                                              batch_average=False))(batch, 2)
    assert not model.training
    assert all(v.device.type == "cuda" for v in ev.values())
    assert int(ev["confusion"].sum()) == 2 * 65 * 65


@pytest.mark.cuda
def test_bincount_confusion_equals_the_hosts(cuda_device):
    import numpy as np

    from deep_active_semantic_segmentation_torch.ops.metrics import confusion_matrix

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    gt = torch.randint(0, 21, (5, 513, 513), device=cuda_device, generator=gen)
    gt[:, :40] = 255
    pred = torch.randint(0, 19, (5, 513, 513), device=cuda_device, generator=gen)
    got = confusion_matrix(gt, pred, 19).cpu().numpy()
    g, p = gt.cpu().numpy(), pred.cpu().numpy()
    valid = g < 19
    ref = np.bincount(19 * g[valid] + p[valid], minlength=19 * 19).reshape(19, 19)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cells,cell,region,count,scale", [
    (4, 12, 5, 13, 25.5, 1.0),
    (4, 12, 5, 13, 25.5, 0.02),          # under the 0.01 stop after a few boxes
    (40, 11, 35, 129, 80, 1.0)])         # 385² maps: crop 513, region 129
def test_square_nms_device_on_the_card_equals_host(cuda_device, n, cells, cell,
                                                   region, count, scale):
    """The device NMS on the card picks the host NMS's boxes, in order, on
    a plateaued stack (few levels: ties inside and across maps)."""
    import numpy as np

    from deep_active_semantic_segmentation_torch.ops import region as region_ops

    rng = np.random.RandomState(n + cells)
    low = rng.randint(0, 4, (n, cells, cells)).astype(np.float32) / 3
    maps = (np.kron(low, np.ones((1, cell, cell), np.float32)) * scale).astype(np.float32)
    host = region_ops.square_nms(maps.copy(), region, count)
    boxes, k = region_ops.square_nms_device(torch.from_numpy(maps).to(cuda_device),
                                            region, int(np.ceil(count)))
    assert boxes.device.type == "cuda"
    dev = region_ops.device_boxes_to_regions(boxes.cpu().numpy(), int(k), n, region)
    assert dev == host


@pytest.mark.cuda
@pytest.mark.parametrize("arch,side", [("deeplab", 65), ("enet", 64)])
@pytest.mark.parametrize("noise_mode", ["input", "feature"])
def test_noise_sweep_through_the_kernel_equals_its_plain_rescore(
        cuda_device, monkeypatch, arch, side, noise_mode):
    """A noise sweep votes through B1 (DeepLab, exact 4x) or B2 (ENet,
    exact 2x) every step; re-scored from the same generator state with the
    kernel's plain version in its place, the entropy maps are equal bit for
    bit through B1 (bit-exact) and on >= 99.5% of pixels through B2 (its
    vote bar)."""
    from deep_active_semantic_segmentation_torch.models.factory import build_model

    model = build_model(arch, 19, mc_dropout=arch == "deeplab", device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    images = torch.randint(0, 256, (2, side, side, 3), dtype=torch.uint8,
                           device=cuda_device, generator=gen.manual_seed(1))
    labels = torch.zeros(2, side, side, dtype=torch.uint8, device=cuda_device)
    op, plain = ((ua.upsample4_argmax, lambda x, out_size=None: ua.upsample4_argmax_plain(x))
                 if arch == "deeplab" else
                 (tv.tconv2x_argmax_parity_major, tv.tconv2x_argmax_parity_major_plain))

    def sweep():
        return kernels.mc_vote_entropy_maps(
            model, images, labels, kernels.mc_generator(0, 0, cuda_device), 19, 6,
            noise_mode, fused_upsample=True)

    before = op.launches
    fused = sweep()
    assert op.launches - before == 6
    monkeypatch.setattr(ua if arch == "deeplab" else tv, op.__name__, plain)
    rescored = sweep()
    assert fused.shape == (2, side, side) and fused.max() > 0
    if arch == "deeplab":
        assert torch.equal(fused, rescored)
    else:
        assert (fused == rescored).float().mean().item() >= 0.995


def _apart_from_f64(feats, seed_mask, picks: dict) -> dict:
    """The first pick where each list parts from the k-center greedy in
    f64 (a failed comparison's message: which side moved)."""
    x = feats.double()
    min_d = torch.cdist(x, x[seed_mask]).min(dim=1).values
    min_d[seed_mask] = 0
    ref = []
    for _ in range(len(next(iter(picks.values())))):
        ref.append(int(min_d.argmax()))
        min_d = torch.minimum(min_d, torch.cdist(x, x[ref[-1]:ref[-1] + 1])[:, 0])
    return {side: next((i for i, (a, b) in enumerate(zip(p, ref)) if a != b), None)
            for side, p in picks.items()}


@pytest.mark.cuda
def test_greedy_selection_on_the_card_equals_the_cpu(cuda_device):
    """k-center greedy and max-representative on the card pick what the
    same functions pick on the CPU (clustered non-negative features, as
    decoder features are; TF32 off)."""
    from deep_active_semantic_segmentation_torch.ops import distance
    from deep_active_semantic_segmentation_torch.selection.kernels import (
        _deterministic_precision)

    gen = torch.Generator().manual_seed(3)
    centers = torch.rand(12, 96, generator=gen) * 4
    feats = torch.relu(centers[torch.randint(0, 12, (900,), generator=gen)]
                       + torch.randn(900, 96, generator=gen))
    seed_mask = torch.zeros(900, dtype=torch.bool)
    seed_mask[:40] = True
    with _deterministic_precision():
        cpu = distance.kcenter_greedy(feats, seed_mask, 60)
        card = distance.kcenter_greedy(feats.to(cuda_device), seed_mask, 60)
        assert card.device.type == "cuda"
        assert card.cpu().tolist() == cpu.tolist(), _apart_from_f64(
            feats, seed_mask, {"card": card.cpu().tolist(), "cpu": cpu.tolist()})
        cand = feats[300:500]
        cpu = distance.max_representative(feats, cand, 40)
        card = distance.max_representative(feats.to(cuda_device),
                                           cand.to(cuda_device), 40)
        assert card.cpu().tolist() == cpu.tolist()


@pytest.mark.cuda
def test_dual_train_step_on_the_card_equals_the_cpu(cuda_device):
    """One f32 dual step of the accuracy predictor (dropout off, BN at
    running statistics, TF32 off) from the same weights on the card and on
    the CPU: the three losses within 1e-4 relative, the updated parameters
    within 1e-3 of the largest weight (chip_smoke.py's card-vs-CPU bars)."""
    import copy

    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import make_schedule
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_dual_train_step)

    gen = torch.Generator().manual_seed(2)
    cpu_model = build_model("accuracy_predictor", 21, device="cpu", generator=gen)
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(cuda_device)}
    image = torch.randint(0, 256, (2, 65, 65, 3), dtype=torch.uint8, generator=gen)
    label = torch.randint(0, 21, (2, 65, 65), dtype=torch.uint8, generator=gen)
    label[:, :5] = 255
    losses = {}
    with kernels._deterministic_precision():
        for dev, model in models.items():
            model.train()
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.eval()
            opt = build_optimizer("SGD", param_groups(model, "accuracy_predictor"))
            step = make_dual_train_step(
                model, opt, build_loss("ce"),
                build_loss("ce", class_weights=torch.tensor([0.75, 0.25], device=dev)),
                make_schedule("step", 0.007, 2, 3))
            out = step({"image": image.to(dev), "label": label.to(dev)}, 0, 0.7, 0.3)
            assert out["loss"].device.type == dev
            losses[dev] = [float(out[k]) for k in ("loss", "loss_dl", "loss_un")]
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b), losses
    card = dict(models["cuda"].named_parameters())
    scale = max(p.detach().abs().max().item() for p in cpu_model.parameters())
    assert max((card[n].detach().cpu() - p.detach()).abs().max().item()
               for n, p in cpu_model.named_parameters()) <= 1e-3 * scale


@pytest.mark.cuda
def test_input_gradient_norms_on_the_card_equal_the_cpu(cuda_device):
    """The only backward among the selectors, on the card and on the CPU
    from the same weights (TF32 off in both): within 1e-3 relative, the bar
    of test_torch_accuracy_driver.py (a ReLU input that rounds to the
    other side of 0 switches a path of the backward off)."""
    import copy

    from deep_active_semantic_segmentation_torch.models.factory import build_model

    gen = torch.Generator().manual_seed(3)
    cpu_model = build_model("accuracy_predictor", 21, device="cpu", generator=gen)
    image = torch.randint(0, 256, (3, 97, 97, 3), dtype=torch.uint8, generator=gen)
    label = torch.randint(0, 21, (3, 97, 97), dtype=torch.uint8, generator=gen)
    label[:, :9] = 255
    got = kernels.input_gradient_norms(copy.deepcopy(cpu_model).to(cuda_device),
                                       image.to(cuda_device), label.to(cuda_device), 21)
    want = kernels.input_gradient_norms(cpu_model, image, label, 21)
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=0)


@pytest.mark.cuda
def test_native_loader_puts_its_batches_on_the_card(cuda_device, tmp_path, monkeypatch):
    """A passive pool's Loader on the card: every resize on the native
    resampler (PIL's resize raises), the device batches equal to the host
    batches byte for byte, the images and labels on the card."""
    import random

    import numpy as np
    from PIL import Image

    from deep_active_semantic_segmentation_torch.data import pools
    from deep_active_semantic_segmentation_torch.data.loader import Loader
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore

    store = DirectoryStore(str(tmp_path), readonly=False)
    rng = np.random.RandomState(0)
    keys = [f"/leftImg8bit/train/city/img_{i}.png".encode() for i in range(5)]
    for key in keys:
        store.put(key, rng.randint(0, 256, (256, 512, 4), dtype=np.uint8))
    store.finalize(keys)
    monkeypatch.setattr(Image.Image, "resize",
                        lambda *a, **kw: pytest.fail("PIL resize called"))
    batches = {}
    for where in ("host", "card"):
        pool = pools.PassivePool(pools.CITYSCAPES, DirectoryStore(str(tmp_path)),
                                 129, 129, "train", rng=random.Random(7))
        loader = Loader(pool, 2, shuffle=True, seed=3, device=cuda_device)
        batches[where] = list(loader if where == "host" else loader.device_batches())
    assert len(batches["card"]) == 3
    for h, c in zip(batches["host"], batches["card"], strict=True):
        assert c["image"].device.type == "cuda" and c["image"].dtype == torch.uint8
        assert torch.equal(c["image"].cpu(), torch.from_numpy(h["image"]))
        assert torch.equal(c["label"].cpu(), torch.from_numpy(h["label"]))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,backbone,side", [("deeplab", "resnet", 65),
                                                ("deeplab", "resnet101", 65),
                                                ("enet", "mobilenet", 64),
                                                ("fastscnn", "mobilenet", 64)])
def test_zoo_forward_on_the_card_equals_the_cpu(cuda_device, arch, backbone, side):
    """The rest of the zoo on the card against the CPU from the same
    weights (TF32 off): eval logits within 1e-4 of the largest."""
    import copy

    from deep_active_semantic_segmentation_torch.models.factory import build_model

    gen = torch.Generator().manual_seed(5)
    cpu_model = build_model(arch, 19, backbone=backbone, device="cpu", generator=gen)
    card_model = copy.deepcopy(cpu_model).to(cuda_device)
    x = torch.randn(2, 3, side, side, generator=gen)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = card_model(x.to(cuda_device)).cpu()
            want = cpu_model(x)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert got.shape == want.shape == (2, 19, side, side)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_sem_batches_reach_the_card_as_on_the_cpu(cuda_device, tmp_path):
    """SEM's uint8 grayscale wire onto the card: the normalized network
    input (SEM's mean and std on the device) equal to the CPU's bit for
    bit, labels 0/1 with the padded row at 255."""
    import random

    import numpy as np
    from PIL import Image

    from deep_active_semantic_segmentation_torch.data import sem
    from deep_active_semantic_segmentation_torch.data.loader import Loader
    from deep_active_semantic_segmentation_torch.parallel.steps import ingest

    rng = np.random.RandomState(0)
    for sub in ("images", "masks"):
        (tmp_path / "sem" / "train" / sub).mkdir(parents=True)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (600, 700), dtype=np.uint8)).save(
            tmp_path / "sem" / "train" / "images" / f"{i}.png")
        Image.fromarray((rng.rand(600, 700) > 0.5).astype(np.uint8) * 255).save(
            tmp_path / "sem" / "train" / "masks" / f"{i}.png")
    batches = {}
    for device in ("cpu", cuda_device):
        pool = sem.SEMData(512, "train", dataset_root=str(tmp_path), rng=random.Random(3))
        loader = Loader(pool, 2, shuffle=True, seed=0, device=device)
        batches[str(device)] = [ingest(b, (sem.MEAN, sem.STD))
                                for b in loader.device_batches()]
    assert len(batches["cuda"]) == 2
    for (ci, cl), (gi, gl) in zip(batches["cpu"], batches["cuda"], strict=True):
        assert gi.device.type == "cuda" and tuple(gi.shape) == (2, 1, 512, 512)
        assert torch.equal(gi.cpu(), ci) and torch.equal(gl.cpu(), cl)
    assert set(batches["cpu"][0][1].unique().tolist()) == {0, 1}
    assert (batches["cpu"][1][1][1] == 255).all()


@pytest.mark.cuda
def test_evaluate_checkpoint_on_the_card_equals_the_cpu(cuda_device, tmp_path, monkeypatch):
    """One checkpoint replayed by ``evaluate_checkpoint`` on the card and
    on the CPU (TF32 off): the same confusion matrix, the losses within
    1e-5 relative."""
    import numpy as np

    from deep_active_semantic_segmentation_torch.config import parse_cli
    from deep_active_semantic_segmentation_torch.data.factory import make_dataloader
    from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
    from deep_active_semantic_segmentation_torch.engine import evaluation
    from deep_active_semantic_segmentation_torch.engine.trainer import Trainer
    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.utils.checkpoint import save_checkpoint

    rng = np.random.RandomState(1)
    city = tmp_path / "cityscapes"
    keys = {}
    for split, n in (("train", 4), ("val", 3)):
        store = DirectoryStore(str(city / split), readonly=False)
        keys[split] = [f"/leftImg8bit/{split}/c/img_{i}.png".encode() for i in range(n)]
        for key in keys[split]:
            lab = rng.randint(0, 19, (90, 130)).astype(np.uint8)
            lab[:10] = 255
            store.put(key, np.dstack((rng.randint(0, 256, (90, 130, 3), dtype=np.uint8),
                                      lab)))
        store.finalize(keys[split])
    (city / "seed_sets").mkdir()
    (city / "seed_sets" / "set_0.txt").write_text(
        "".join(k.decode() + "\n" for k in keys["train"][:2]))
    ckpt = str(tmp_path / "best.ckpt")
    model = build_model("deeplab", 19, mc_dropout=True, device="cpu",
                        generator=torch.Generator().manual_seed(4))
    save_checkpoint(ckpt, model, None, 3, 0.5)
    cfg = parse_cli(["--dataset", "active_cityscapes_image", "--backbone", "mobilenet",
                     "--base-size", "65", "--crop-size", "65", "--batch-size", "2",
                     "--use-balanced-weights", "--seed", "1"]).finalize()
    made = []
    real = evaluation.Evaluator
    monkeypatch.setattr(evaluation, "Evaluator", lambda *a: made.append(real(*a)) or made[-1])
    results = {}
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for device in ("cpu", cuda_device):
            _, train_loader, val_loader, _, nclass = make_dataloader(
                cfg.dataset, 65, 65, 2, init_set="set_0.txt", dataset_root=str(tmp_path),
                seed=1, device=device)
            trainer = Trainer(cfg, train_loader, val_loader, nclass, device=device)
            trainer.initialize()
            results[str(device)] = evaluation.evaluate_checkpoint(trainer, ckpt)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert made[1].device.type == "cuda" and made[1].confusion.sum() > 0.8 * 3 * 65 * 65
    np.testing.assert_array_equal(made[1].confusion, made[0].confusion)
    assert results["cuda"]["mIoU"] == results["cpu"]["mIoU"]
    assert results["cuda"]["epoch"] == 3
    assert abs(results["cuda"]["loss"] - results["cpu"]["loss"]) <= 1e-5 * results["cpu"]["loss"]


@pytest.fixture
def nccl_mesh(cuda_device):
    """A one-rank process group over NCCL on the card (the production
    route of a data-parallel run), closed after the test."""
    from deep_active_semantic_segmentation_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cuda", backend="nccl", timeout=120)
    yield mesh
    mesh.close()


@pytest.mark.cuda
def test_cross_replica_bn_at_world_one_equals_sync_and_plain_bn(nccl_mesh):
    """Forward, backward and running statistics of CrossReplicaBatchNorm2d
    at world 1 over NCCL against nn.SyncBatchNorm and BatchNorm2d on the
    same f32 input (within 1e-5 of the largest: its f64 sums against
    cuDNN's f32 ones)."""
    from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
        CrossReplicaBatchNorm2d)

    dev = nccl_mesh.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = 2 + 3 * torch.randn(8, 16, 33, 33, device=dev, generator=gen)
    dy = torch.randn(x.shape, device=dev, generator=gen)
    results = []
    for bn in (CrossReplicaBatchNorm2d(16, nccl_mesh), torch.nn.SyncBatchNorm(16),
               torch.nn.BatchNorm2d(16)):
        bn = bn.to(dev).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 16))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, 16))
        xg = x.clone().requires_grad_(True)
        y = bn(xg)
        (y * dy).sum().backward()
        results.append([t.detach() for t in (y, xg.grad, bn.weight.grad, bn.bias.grad,
                                             bn.running_mean, bn.running_var)])
    for other in results[1:]:
        for got, want in zip(results[0], other):
            assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_nccl_ddp_step_at_world_one_equals_the_plain_step(nccl_mesh):
    """One DeepLab step through DistributedDataParallel with cross-replica
    BN over the one-rank NCCL group against the plain one-card step, TF32
    off: with BN at running statistics the same tensors; in train mode,
    f64 (BN biases off the ReLU6 kinks), within 1e-9 of the largest
    weight."""
    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
        constant_schedule)
    from deep_active_semantic_segmentation_torch.parallel.crossreplica import (
        convert_cross_replica_bn)
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import make_train_step

    dev = nccl_mesh.device
    gen = torch.Generator(device=dev).manual_seed(3)
    image = torch.randint(0, 256, (4, 65, 65, 3), dtype=torch.uint8, device=dev,
                          generator=gen)
    label = torch.randint(0, 19, (4, 65, 65), device=dev, generator=gen).to(torch.uint8)
    ref = build_model("deeplab", 19, mc_dropout=True, device=dev, generator=gen)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    weights = ref.state_dict()
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float64, device=dev)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float64, device=dev)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for frozen, dtype, bar in ((True, torch.float32, 1e-6), (False, torch.float64, 1e-9)):
            states, losses = [], []
            for mesh in (nccl_mesh, None):
                model = build_model("deeplab", 19, mc_dropout=True, device=dev)
                model.load_state_dict(weights)
                convert_cross_replica_bn(model.train(), mesh)
                if frozen:
                    for m in model.modules():
                        if isinstance(m, torch.nn.BatchNorm2d):
                            m.eval()
                model.to(dtype)
                x = image if dtype == torch.float32 else (image.double() / 255 - mean) / std
                step = make_train_step(
                    model, build_optimizer("SGD", param_groups(model, "deeplab")),
                    build_loss("ce", mesh=mesh), constant_schedule(0.01), mesh=mesh)
                losses.append(float(step({"image": x, "label": label}, 0)["loss"]))
                states.append(model.state_dict())
            assert abs(losses[0] - losses[1]) <= 1e-6 * losses[1]
            scale = max(v.abs().max() for v in states[1].values() if v.is_floating_point())
            err = max((states[0][k] - v).abs().max() for k, v in states[1].items()
                      if v.is_floating_point())
            assert err <= bar * scale, (frozen, float(err), float(scale))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_dual_step_on_two_ranks_sharing_the_card_equals_one_process(cuda_device, tmp_path):
    """The accuracy predictor's two-headed step (DeepLab-MobileNetV2 and
    the UNet error head, 21 classes at 65², train-mode cross-replica BN,
    dropout from a generator on the card) on two gloo ranks sharing
    ``cuda:0``, 2 rows each, against one process on the card on the 4
    images: f64 weights, within 1e-9 of the largest weight."""
    import numpy as np

    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.parallel import mesh as pt_mesh
    import torch_parallel_workers as workers

    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(11)
    model = build_model("accuracy_predictor", 21, device="cpu", generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    label = np.kron(rng.randint(0, 21, (4, 5, 5)), np.ones((1, 13, 13), int)).astype(np.uint8)
    label[0, :30] = 255
    image = rng.randint(0, 256, label.shape + (3,), dtype=np.uint8)
    setup = {"nclass": 21, "w_wrong": np.asarray([0.75, 0.25], np.float32),
             "cw": rng.uniform(0.5, 2.0, 21).astype(np.float32), "dropout_seed": 7,
             "deeplab": {"state_dict": model.state_dict(), "image": image, "label": label}}
    torch.save(setup, str(tmp_path / "setup.pt"))
    pt_mesh.launch(workers.dual_card_checks, (str(tmp_path / "setup.pt"), str(tmp_path)),
                   num_devices=2, device="cuda:0", backend="gloo", timeout=120,
                   join_timeout=300)
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(2)]
    ref_loss, ref = workers.dual_train_step(
        setup, None, torch.Generator(device=cuda_device).manual_seed(7), torch.float64,
        device=cuda_device)
    (loss0, sd0), (loss1, sd1) = (r["dropout_step"] for r in ranks)
    assert loss0 == loss1 and all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    for k, v in ref_loss.items():
        assert abs(loss0[k] - v) <= 1e-6 * abs(v), k
    floats = [k for k, v in ref.items() if v.is_floating_point()]
    scale = max(float(ref[k].abs().max()) for k in floats)
    err = max(float((sd0[k] - ref[k]).abs().max()) for k in floats)
    assert err <= 1e-9 * scale, (err, scale)


@pytest.mark.cuda
def test_spatial_step_on_two_ranks_sharing_the_card_equals_one_process(cuda_device,
                                                                        tmp_path):
    """The height-sharded DeepLab-MobileNetV2 step (a (1x2) mesh of two
    gloo ranks sharing ``cuda:0``, 32 rows of 2 images at side 64 each,
    dropout from a generator on the card) against one process on the
    card on the whole images: f64 weights, the state (BN running
    statistics included) within 1e-10 of the largest, the f32 loss within
    1e-6."""
    import numpy as np

    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.parallel import mesh as pt_mesh
    import torch_parallel_workers as workers

    rng = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(11)
    model = build_model("deeplab", 19, mc_dropout=True, device="cpu", generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    label = np.kron(rng.randint(0, 19, (2, 4, 4)), np.ones((1, 16, 16), int)).astype(np.uint8)
    label[:, :20] = 255
    image = rng.randint(0, 256, label.shape + (3,), dtype=np.uint8)
    setup = {"state_dict": model.state_dict(), "image": image, "label": label,
             "cw": rng.uniform(0.5, 2.0, 19).astype(np.float32), "dropout_seed": 7}
    torch.save(setup, str(tmp_path / "setup.pt"))
    pt_mesh.launch(workers.spatial_card_checks, (str(tmp_path / "setup.pt"), str(tmp_path)),
                   num_devices=2, device="cuda:0", backend="gloo", timeout=120,
                   join_timeout=300, spatial=2)
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(2)]
    ref_loss, ref = workers.spatial_train_step(None, setup, dropout_seed=7,
                                               device=cuda_device)
    (loss0, sd0), (loss1, sd1) = (r["f64_step"] for r in ranks)
    assert loss0 == loss1 and all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert abs(loss0 - ref_loss) <= 1e-6 * abs(ref_loss)
    floats = [k for k, v in ref.items() if v.is_floating_point()]
    scale = max(float(ref[k].abs().max()) for k in floats)
    err = max(float((sd0[k] - ref[k]).abs().max()) for k in floats)
    assert err <= 1e-10 * scale, (err, scale)


@pytest.mark.cuda
def test_enet_spatial_step_on_two_ranks_sharing_the_card_equals_one_process(cuda_device,
                                                                             tmp_path):
    """The height-sharded ENet step (its pool, unpool and transposed-conv
    halos; a (1x2) mesh of two gloo ranks sharing ``cuda:0``, 32 rows of
    2 images at side 64 each, dropout from a generator on the card)
    against one process on the card on the whole images: f64 weights,
    the state (BN running statistics included) within 1e-10 of the
    largest, the f32 loss within 1e-6. The class weights lie on a 1/8
    grid, so the loss's f32 normalizer is exact in any summation order."""
    import numpy as np

    from deep_active_semantic_segmentation_torch.models.factory import build_model
    from deep_active_semantic_segmentation_torch.parallel import mesh as pt_mesh
    import torch_parallel_workers as workers

    rng = np.random.RandomState(1)
    gen = torch.Generator().manual_seed(12)
    model = build_model("enet", 5, device="cpu", generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    label = np.kron(rng.randint(0, 5, (2, 4, 4)), np.ones((1, 16, 16), int)).astype(np.uint8)
    label[:, :20] = 255
    image = rng.randint(0, 256, label.shape + (3,), dtype=np.uint8)
    setup = {"arch": "enet", "classes": 5, "state_dict": model.state_dict(),
             "image": image, "label": label,
             "cw": (rng.randint(4, 17, 5) / 8).astype(np.float32), "dropout_seed": 7}
    torch.save(setup, str(tmp_path / "setup.pt"))
    pt_mesh.launch(workers.spatial_card_checks, (str(tmp_path / "setup.pt"), str(tmp_path)),
                   num_devices=2, device="cuda:0", backend="gloo", timeout=120,
                   join_timeout=300, spatial=2)
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(2)]
    ref_loss, ref = workers.spatial_train_step(None, setup, dropout_seed=7,
                                               device=cuda_device)
    (loss0, sd0), (loss1, sd1) = (r["f64_step"] for r in ranks)
    assert loss0 == loss1 and all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert abs(loss0 - ref_loss) <= 1e-6 * abs(ref_loss)
    floats = [k for k, v in ref.items() if v.is_floating_point()]
    scale = max(float(ref[k].abs().max()) for k in floats)
    err = max(float((sd0[k] - ref[k]).abs().max()) for k in floats)
    assert err <= 1e-10 * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deeplab", "enet", "accuracy_predictor"])
def test_remat_step_on_the_card_equals_the_plain_step(cuda_device, arch):
    """``remat=True`` on the card (one checkpoint per block): one f64 step
    of DeepLab-MobileNetV2, ENet or the two-headed predictor at 64², train-
    mode BN, dropout from a generator on the card, equals the plain step
    from the same generator state: the loss within 1e-12 relative, every
    parameter and BN buffer within 1e-12 of the largest (the resizes'
    atomic adds round in any order), ``num_batches_tracked`` and the
    generator's state after the step equal."""
    import copy

    from deep_active_semantic_segmentation_torch.models.factory import (
        build_model, param_groups)
    from deep_active_semantic_segmentation_torch.ops.losses import build_loss
    from deep_active_semantic_segmentation_torch.ops.lr_schedule import (
        constant_schedule)
    from deep_active_semantic_segmentation_torch.parallel.optim import build_optimizer
    from deep_active_semantic_segmentation_torch.parallel.steps import (
        make_dual_train_step, make_train_step)

    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(5)
    classes = 21 if arch == "accuracy_predictor" else 19
    plain = build_model(arch, classes, mc_dropout=True, device=dev, generator=gen)
    with torch.no_grad():
        for m in plain.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    plain = plain.double().train()
    remat = copy.deepcopy(plain)
    image = torch.rand(2, 64, 64, 3, dtype=torch.float64, device=dev, generator=gen)
    label = torch.randint(0, classes, (2, 64, 64), device=dev, generator=gen).to(torch.uint8)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    losses, states = [], []
    try:
        for model, on in ((plain, False), (remat, True)):
            drops = torch.Generator(device=dev).manual_seed(7)
            opt = build_optimizer("SGD", param_groups(model, arch))
            if arch == "accuracy_predictor":
                step = make_dual_train_step(model, opt, build_loss("ce"), build_loss("ce"),
                                            constant_schedule(0.01), generator=drops,
                                            remat=on)
                out = step({"image": image, "label": label}, 0, 0.7, 0.3)
            else:
                step = make_train_step(model, opt, build_loss("ce"),
                                       constant_schedule(0.01), generator=drops,
                                       remat=on)
                out = step({"image": image, "label": label}, 0)
            losses.append(float(out["loss"]))
            states.append((model.state_dict(), drops.get_state()))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert abs(losses[1] - losses[0]) <= 1e-12 * abs(losses[0])
    (want, want_gen), (got, got_gen) = states
    scale = max(float(v.abs().max()) for v in want.values() if v.is_floating_point())
    for k, v in want.items():
        if v.is_floating_point():
            assert float((got[k] - v).abs().max()) <= 1e-12 * scale, k
        else:
            assert torch.equal(got[k], v), k
    assert torch.equal(got_gen, want_gen)


@pytest.mark.cuda
def test_the_step_tracer_counts_b2_launches_per_enet_mc_step(cuda_device):
    """``tools/trace_step_torch.py``'s ``enet_mc`` at toy size on the card:
    its table names B2's kernel 20 times (MC_STEPS) per profiled scoring
    step, the launch counter agrees (warm-up steps included), and no B1
    kernel runs."""
    from deep_active_semantic_segmentation_torch import constants
    from tools import trace_step_torch as tool

    before = (ua.upsample4_argmax.launches, tv.tconv2x_argmax_parity_major.launches)
    table = tool.trace("enet_mc", 64, 2, cuda_device, steps=2, warmup=1, top=None)
    b2 = [op for op in table["ops"] if "tconv2x_argmax_parity_major_kernel" in op["name"]]
    assert len(b2) == 1 and b2[0]["launches"] == constants.MC_STEPS
    assert not any("upsample4_argmax_kernel" in op["name"] for op in table["ops"])
    assert ua.upsample4_argmax.launches == before[0]
    assert tv.tconv2x_argmax_parity_major.launches == before[1] + 3 * constants.MC_STEPS
    assert 0 < table["total_ms"] <= table["wall_ms"]
