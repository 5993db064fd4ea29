"""The port's pool scoring and AL loop sharded over two gloo ranks on the
CPU, against the port's own one-rank run and the JAX package's sharded MC
sweep; the train/eval Loader's per-rank rows; the data-parallel dry run.

The pool is sharded by whole scoring batches (rank r scores batches i
with i mod 2 = r; 10 images in batches of 4: rank 0 scores two batches,
rank 1 one) and each batch keeps its global index for its MC generator,
so every score, feature, weak label, region box and pick of the two
ranks equals the one-rank port's exactly (DeepLab through B1's plain
version, ENet through B2's). Against JAX, whose shards fold their index
into the key, the MC mean entropy is held inside the JAX package's own
seed-to-seed band (test_torch_scoring.py's rule).

Every spawn has its own limit (the process group's timeout and a join
timeout), so a stuck rank fails the test instead of hanging it."""

import dataclasses
import random
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import active_train_torch
from deep_active_semantic_segmentation_torch import config as pt_config
from deep_active_semantic_segmentation_torch import constants
from deep_active_semantic_segmentation_torch.data import pools as pt_pools
from deep_active_semantic_segmentation_torch.data.loader import Loader
from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
from deep_active_semantic_segmentation_torch.engine import trainer as pt_trainer
from deep_active_semantic_segmentation_torch.engine.active_loop import (
    run_active_loop)
from deep_active_semantic_segmentation_torch.parallel import mesh as pt_mesh
from deep_active_semantic_segmentation_torch.parallel.dryrun import dryrun_multichip
from deep_active_semantic_segmentation_torch.selection import ModelBundle
from deep_active_semantic_segmentation_tpu.data.loader import (
    PathsLoader as JaxPathsLoader)
from deep_active_semantic_segmentation_tpu.data.store import (
    DirectoryStore as JaxDirectoryStore)
from deep_active_semantic_segmentation_tpu.parallel.mesh import make_mesh as jx_make_mesh
from deep_active_semantic_segmentation_tpu.selection import kernels as jx_kernels
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    NUM_CLASSES, jax_deeplab, jax_enet, one_torch_thread, port_deeplab, port_enet,
    selections, write_dataset, write_pool)
import torch_parallel_workers as workers

WORLD = 2
BATCH = 4
MC_STEPS = 4
K = 3
CROP = {"deeplab": 33, "enet": 32}
JOIN_TIMEOUT_S = 300
GROUP_TIMEOUT_S = 120


def spawn(fn, setup, tmp_path):
    """Run ``fn`` on WORLD gloo ranks on the CPU with ``setup``; each
    rank's saved results."""
    setup_path = str(tmp_path / "setup.pt")
    torch.save(setup, setup_path)
    pt_mesh.launch(fn, (setup_path, str(tmp_path)), num_devices=WORLD,
                   device="cpu", timeout=GROUP_TIMEOUT_S,
                   join_timeout=JOIN_TIMEOUT_S)
    return [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """The queries on both models: on two ranks, and on one."""
    root = str(tmp_path_factory.mktemp("sharded_pool"))
    keys = write_pool(DirectoryStore(root, readonly=False), 10, seed=2)
    jmodel, params, stats = jax_deeplab(seed=1)
    models = {"deeplab": (port_deeplab(params, stats), CROP["deeplab"]),
              "enet": (port_enet(*jax_enet(seed=6, encoder_relu=True,
                                           decoder_relu=True)[1:],
                                 encoder_relu=True, decoder_relu=True), CROP["enet"])}
    setup = {"root": root, "keys": keys, "models": models, "batch": BATCH,
             "k": K, "mc_steps": MC_STEPS, "rng_seed": 9}
    with ThreadPoolExecutor(1) as pool:   # the ranks run while this process does
        ranks = pool.submit(spawn, workers.scoring_checks, setup,
                            tmp_path_factory.mktemp("scored"))
        saved = constants.MC_STEPS
        constants.MC_STEPS = MC_STEPS
        try:
            one = {arch: workers.scoring_queries(
                       workers.scoring_selectors(DirectoryStore(root), crop, BATCH),
                       ModelBundle(model.eval(), torch.device("cpu")), keys, K, 9)
                   for arch, (model, crop) in models.items()}
        finally:
            constants.MC_STEPS = saved
        return root, keys, (jmodel, params, stats), ranks.result(), one


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


QUERIES = ["variance", "variance_scores", "noise_image", "noise_variance",
           "ceal_confidence", "ceal_margin", "ceal_entropy", "ceal_entropies",
           "ceal_fusion", "weak_labels", "coreset_features", "coreset"]


@pytest.mark.parametrize("arch", ["deeplab", "enet"])
@pytest.mark.parametrize("query", QUERIES)
def test_two_rank_query_equals_one_rank(scored, arch, query):
    """Every query's result on both ranks equals the one-rank port's; the
    fusion's shuffled union is rank 0's on both ranks: before the shuffle
    its order follows each process's hash seed, as in the reference."""
    *_, ranks, one = scored
    if query == "ceal_fusion":
        union = {p for q in ("ceal_confidence", "ceal_margin", "ceal_entropy")
                 for p in one[arch][q]}
        assert ranks[0][arch][query] == ranks[1][arch][query]
        assert len(ranks[0][arch][query]) == K and set(ranks[0][arch][query]) <= union
        return
    for rank in ranks:
        assert _equal(rank[arch][query], one[arch][query]), (arch, query)
    if query == "weak_labels":
        assert 0 < len(one[arch][query]) < 10


@pytest.mark.parametrize("query", ["regions", "representative"])
def test_two_rank_regions_and_representatives_equal_one_rank(scored, query):
    """The region round's boxes: each rank's NMS over its own maps, merged
    (selection/region_pipeline.py); and the max-subset stage's features
    gathered to both ranks."""
    *_, ranks, one = scored
    for rank in ranks:
        assert _equal(rank["deeplab"][query], one["deeplab"][query])
    if query == "regions":
        boxes, count = one["deeplab"]["regions"]
        assert count == sum(len(v) for v in boxes.values()) > 1


def test_two_rank_mc_entropy_within_jax_sharded_band(scored):
    """JAX's mc_vote_entropy_maps_sharded on a 2-device mesh over 4 seeds
    gives the seed-to-seed band; the port's two-rank scores sit in it."""
    root, keys, (jmodel, params, stats), ranks, _ = scored
    mesh = jx_make_mesh(WORLD)
    sharding = jax.sharding.NamedSharding(
        jax.sharding.Mesh(mesh.devices.reshape(-1), ("pool",)),
        jax.sharding.PartitionSpec("pool"))
    batches = list(JaxPathsLoader(JaxDirectoryStore(root), keys, CROP["deeplab"],
                                  BATCH, include_labels=True, device_normalize=True,
                                  labels_as_mask=NUM_CLASSES))
    jax_scores = []
    for seed in range(4):
        s = []
        for i, b in enumerate(batches):
            maps = jx_kernels.mc_vote_entropy_maps_sharded(
                mesh, jmodel, {"params": params, "batch_stats": stats},
                jax.device_put(b["image"], sharding), jax.device_put(b["label"], sharding),
                jax.random.fold_in(jax.random.PRNGKey(seed), i), NUM_CLASSES,
                MC_STEPS, "dropout", fused_upsample=True, labels_packed=True)
            s.extend(np.asarray(jnp.mean(maps, axis=(1, 2)))[:b["nvalid"]])
        jax_scores.append(s)
    jax_scores = np.asarray(jax_scores)
    port = np.asarray(ranks[0]["deeplab"]["variance_scores"])
    assert np.isfinite(port).all() and (port > 0).all()
    spread = jax_scores.max(axis=0) - jax_scores.min(axis=0)
    gap = np.abs(port - jax_scores.mean(axis=0))
    assert gap.mean() <= spread.mean(), (gap, spread)


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("crop", [33, -1])
def test_rank_rows_equal_the_one_rank_global_batch(tmp_path, crop):
    """Two epochs of the shuffled train Loader (7 images, global batch 4:
    the last batch holds 3, so rank 1's second row is a pad of the global
    batch's first image, which rank 0 decoded): each rank's rows are the
    one-rank batch's rows byte for byte, while every rank takes every
    image's flip and blur draws (one or two), so the host streams end
    where the one-rank stream ends."""
    write_pool(DirectoryStore(str(tmp_path), readonly=False), 7, seed=3)
    rngs = [random.Random(11) for _ in range(WORLD + 1)]
    loaders = [Loader(pt_pools.ActiveImagePool(
        pt_pools.CITYSCAPES, DirectoryStore(str(tmp_path)), 40, crop, "train",
        rng=rng), BATCH, shuffle=True, seed=9, rank=r % WORLD,
        world=WORLD if r < WORLD else 1) for r, rng in enumerate(rngs)]
    ranks, one = loaders[:WORLD], loaders[WORLD]
    for _ in range(2):
        got = [list(loader) for loader in ranks]
        want = list(one)
        assert [[b["nvalid"] for b in g] for g in got] == [[2, 2], [2, 1]]
        for r, rank_batches in enumerate(got):
            for a, b in zip(rank_batches, want, strict=True):
                for k in ("image", "label"):
                    np.testing.assert_array_equal(a[k], b[k][2 * r:2 * r + 2])
    draws = {rng.random() for rng in rngs}
    assert len(draws) == 1


# -------------------------------------------------------------------- loop

TOY = ["--dataset", "active_cityscapes_image", "--backbone", "mobilenet",
       "--base-size", "33", "--crop-size", "33", "--batch-size", str(BATCH),
       "--epochs", "1", "--active-batch-size", "3", "--max-iterations", "2",
       "--lr", "0.01", "--use-balanced-weights", "--workers", "0",
       "--no-early-stop", "--seed", "3"]


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """Two-round `variance` and `ceal_confidence` loops on two ranks and on
    one, every round selecting with one set of weights."""
    root = str(tmp_path_factory.mktemp("loop_data"))
    write_dataset(root, n_train=16)
    _, params, stats = jax_deeplab(seed=2)
    state_dict = port_deeplab(params, stats).state_dict()
    modes = {"v": "variance", "c": "ceal_confidence"}
    argv = {name: TOY + ["--active-selection-mode", mode, "--checkname", name]
            for name, mode in modes.items()}
    runs2 = str(tmp_path_factory.mktemp("runs2"))
    setup = {"root": root, "runs": runs2, "state_dict": state_dict,
             "mc_steps": MC_STEPS,
             "configs": [pt_config.parse_cli(a).finalize(n_devices=WORLD)
                         for a in argv.values()]}
    runs1 = str(tmp_path_factory.mktemp("runs1"))
    with ThreadPoolExecutor(1) as pool:   # the ranks run while this process does
        ranks = pool.submit(spawn, workers.loop_checks, setup,
                            tmp_path_factory.mktemp("loop"))
        patch = pytest.MonkeyPatch()
        patch.setattr(pt_trainer.Trainer, "load_best_checkpoint",
                      lambda self: self.model.load_state_dict(state_dict))
        patch.setattr(constants, "MC_STEPS", MC_STEPS)
        try:
            for a in argv.values():
                run_active_loop(pt_config.parse_cli(a).finalize(), dataset_root=root,
                                runs_root=runs1, device="cpu")
        finally:
            patch.undo()
        return runs1, runs2, ranks.result()


@pytest.mark.parametrize("name", ["v", "c"])
def test_two_rank_loop_selects_as_one_rank(loops, name):
    """One selections.txt per round, written by rank 0, equal to the
    one-rank loop's on the same weights; both ranks hold the same labeled
    pool after every selection (the loop checks it too)."""
    runs1, runs2, ranks = loops
    got = selections(runs2, "active_cityscapes_image", name)
    want = selections(runs1, "active_cityscapes_image", name)
    assert got == want and sorted(got) == ["run_0031", "run_0050"]
    assert [len(t.splitlines()) for t in got.values()] == [5, 8]
    labeled = [r[name]["labeled"] for r in ranks]
    assert labeled[0] == labeled[1] and len(labeled[0]) == 1
    assert [p.decode() for p in labeled[0][0]] == got["run_0050"].decode().split()
    assert ranks[0][name]["rounds"] == ranks[1][name]["rounds"]


def test_indivisible_batch_is_refused_before_any_rank_starts(tmp_path):
    with pytest.raises(ValueError, match="--batch-size 5 does not divide over 2 ranks"):
        active_train_torch.main(TOY[:6] + ["--batch-size", "5", "--num-devices", "2"],
                                device="cpu", dataset_root=str(tmp_path))


def test_dryrun_multichip_on_two_cpu_ranks():
    line = dryrun_multichip(WORLD, device="cpu", join_timeout=JOIN_TIMEOUT_S)
    assert line.startswith("dryrun_multichip: n=2 mesh=(2x1)")
    assert "pool_scores_ok=True" in line and line.endswith("OK")


def test_config_of_two_ranks_scales_batch_and_lr():
    cfg = pt_config.parse_cli(["--dataset", "cityscapes", "--seed", "1",
                               "--num-devices", "2"]).finalize(n_devices=WORLD)
    one = pt_config.parse_cli(["--dataset", "cityscapes", "--seed", "1"]).finalize()
    assert (cfg.batch_size, one.batch_size) == (8, 4)
    assert cfg.lr == one.lr == 0.01 and cfg.sync_bn and not one.sync_bn
    assert dataclasses.replace(cfg, batch_size=4, test_batch_size=4, sync_bn=False,
                               num_devices=None) == one


def test_train_torch_on_two_ranks_writes_one_experiment(tmp_path):
    """train.py's path on two gloo ranks through train_torch.main: one
    experiment directory, written by rank 0, whose checkpoint keeps the
    reference key names (no DDP 'module.' prefix) and loads into a model."""
    import train_torch
    from deep_active_semantic_segmentation_torch.models.factory import build_model

    root, runs = str(tmp_path / "data"), tmp_path / "runs"
    write_dataset(root, n_train=8)
    assert train_torch.main(
        ["--dataset", "cityscapes", "--backbone", "mobilenet", "--base-size", "33",
         "--crop-size", "33", "--epochs", "1", "--batch-size", "4", "--lr", "0.01",
         "--seed", "3", "--checkname", "p2", "--workers", "0", "--num-devices", "2"],
        dataset_root=root, runs_root=str(runs), device="cpu") is None
    exp = runs / "cityscapes" / "p2"
    assert sorted(p.name for p in exp.iterdir()) == ["experiment_0", "model_best.ckpt"]
    assert (exp / "experiment_0" / "best_pred.txt").exists()
    state = torch.load(str(exp / "model_best.ckpt"), weights_only=True)["state_dict"]
    assert not any(k.startswith("module.") for k in state)
    build_model("deeplab", NUM_CLASSES, device="cpu").load_state_dict(state)
