"""One rank of the port's data-parallel tests (tests/test_torch_port_parallel*.py).

    python tests/_torch_port_parallel_worker.py <scenario> <rank> <world> <dir>

joins a gloo group through a FileStore in <dir>, runs the scenario on the
CPU and writes its results to <dir>/<scenario>_<rank>.pt. It imports only
the port (no JAX), so a rank starts in a few seconds; the test process
computes the references. The scenarios' inputs come from <dir> (written by
the test) or from the seeded builders below, which the tests also call in
one process for the single-process references.
"""
import contextlib
import json
import os
import sys
import types

import numpy as np
import torch

torch.set_num_threads(1)

from centernet_lightning_torch.data import CollateDetection, CollateTracking  # noqa: E402
from centernet_lightning_torch.models import fairmot as fairmot_mod  # noqa: E402
from centernet_lightning_torch.models import layers  # noqa: E402
from centernet_lightning_torch.models.centernet import CenterNet  # noqa: E402
from centernet_lightning_torch.models.fairmot import FairMOT  # noqa: E402
from centernet_lightning_torch.parallel import dist  # noqa: E402
from centernet_lightning_torch.train import Trainer  # noqa: E402
from centernet_lightning_torch.train import optim as t_optim  # noqa: E402
from centernet_lightning_torch.train import state as t_state  # noqa: E402

IMG = 64
SMALL = dict(num_classes=3, backbone="resnet18", backbone_config={"width": 16},
             neck="FPN", neck_config={"out_channels": 8},
             head_config={"width": 8, "depth": 1}, num_detections=12,
             image_size=(IMG, IMG))
TRACK = dict(SMALL, num_classes=1, reid_config={"emb_dim": 8, "max_track_ids": 8})
TRACKER = {"detection_threshold": 0.0, "min_birth_age": 1, "num_detections": 12}
OPT = {"optimizer": "Adam", "lr": 1e-3, "warmup_epochs": 0}


# ---- one train step from given weights, three ways ------------------------

@contextlib.contextmanager
def variant(name):
    """'global': the port as it is. 'local_norm': each rank divides its
    losses by its own counts and pairs its own triplet rows.
    'local_bn': each rank's BatchNorm takes its own batch's statistics."""
    saved = (dist.global_normalizer, fairmot_mod.reid_triplet_loss, layers.dist)
    if name == "local_norm":
        def local(count, floor=None, eps=0.0):
            total = torch.clamp(count, min=floor) if floor is not None else count
            return total + eps if eps else total

        def own_pairs(emb, ids, mask):
            # the triplet loss of this rank's rows of the gathered batch;
            # the zero term keeps the gather in every rank's backward, so
            # that the ranks run the same collectives
            n = emb.shape[0] // dist.process_count()
            rows = slice(dist.process_index() * n, (dist.process_index() + 1) * n)
            return saved[1](emb[rows], ids[rows], mask[rows]) + 0.0 * emb.sum()
        dist.global_normalizer = local
        fairmot_mod.reid_triplet_loss = own_pairs
    elif name == "local_bn":
        layers.dist = types.SimpleNamespace(process_count=lambda: 1)
    try:
        yield
    finally:
        dist.global_normalizer, fairmot_mod.reid_triplet_loss, layers.dist = saved


def one_step(case, rank, world):
    """The step of `case` ({cfg, fairmot, opt, state_dict, batch}) on this
    rank's rows of the batch: {"state": state dict, "losses": floats}."""
    task = (FairMOT if case["fairmot"] else CenterNet)(**case["cfg"])
    model = task.model.to(memory_format=torch.channels_last)
    model.load_state_dict(case["state_dict"], strict=True)
    state = t_state.TrainState(model=model,
                               tx=t_optim.make_optimizer(model, **case["opt"]))
    step = t_state.make_train_step(task)
    n = case["batch"]["image"].shape[0] // world
    half = {k: torch.from_numpy(np.ascontiguousarray(v[rank * n:(rank + 1) * n]))
            for k, v in case["batch"].items()}
    state, losses = step(state, half)
    return {"state": {k: v.clone() for k, v in model.state_dict().items()},
            "losses": {k: float(v) for k, v in losses.items()}}


def scenario_steps(rank, world, tmp):
    cases = torch.load(os.path.join(tmp, "steps_in.pt"), weights_only=False)
    out = {}
    for name, case in cases.items():
        for v in case["variants"]:
            with variant(v):
                out[name, v] = one_step(case, rank, world)
    return out


# ---- validation on stubbed detections --------------------------------------

def _items(rng, n, tracking=False, seq=0):
    """n samples of bright rectangles on noise, xywh boxes; detection items
    with crowds and areas, tracking items moving a pixel a frame."""
    items = []
    for f in range(n):
        img = rng.integers(0, 60, (IMG, IMG, 3), dtype=np.uint8)
        k = int(rng.integers(1, 5))
        wh = rng.uniform(6, 24, (k, 2))
        xy = rng.uniform(0, IMG - wh)
        if tracking:
            k, wh = 3, np.full((3, 2), 12.0)
            xy = np.array([[4.0 + f, 6.0], [30.0, 20.0 + f], [10.0 + f, 40.0]])
        for (x, y), (w, h) in zip(xy.astype(int), wh.astype(int)):
            img[y:y + h, x:x + w] = 230
        item = {"image": img,
                "bboxes": np.concatenate([xy, wh], 1).astype(np.float32),
                "labels": rng.integers(0, 1 if tracking else 3, k)}
        if tracking:
            item.update(ids=np.arange(k) + 10 * seq, sequence_id=seq)
        else:
            item.update(iscrowd=(rng.uniform(size=k) < 0.2).astype(np.int64),
                        area=(wh.prod(1) * 0.9).astype(np.float32))
        items.append(item)
    return items


def val_batches(tracking):
    """Detection: 5 batches of 2. Tracking: sequences of 5, 3 and 4 frames
    in batches of 2 that may span two sequences."""
    rng = np.random.default_rng(3)
    if not tracking:
        collate = CollateDetection(8)
        return [collate(_items(rng, 2)) for _ in range(5)]
    items = [it for s, n in enumerate((5, 3, 4))
             for it in _items(rng, n, True, s)]
    collate = CollateTracking(8)
    return [collate(items[i:i + 2]) for i in range(0, len(items), 2)]


def stub_detections(batch, tracking, k=12):
    """Detections near the batch's ground truth, drawn from a seed of the
    batch's own pixels (so every process draws the same for a batch)."""
    rng = np.random.default_rng(int(batch["image"].astype(np.int64).sum()))
    n = batch["image"].shape[0]
    kk = min(k, batch["boxes"].shape[1])
    gt = np.where(batch["mask"][..., None] > 0, batch["boxes"], 0)[:, :kk]
    boxes = np.concatenate([gt[..., :2], gt[..., :2] + gt[..., 2:]], -1)
    boxes = np.concatenate([boxes, np.zeros((n, k - kk, 4))], 1)
    fill = rng.uniform(0, IMG - 12, (n, k, 2))
    rand = np.concatenate([fill, fill + rng.uniform(4, 12, (n, k, 2))], -1)
    real = (boxes[..., 2] > 0)[..., None]
    labels = np.pad(batch["labels"][:, :kk], ((0, 0), (0, k - kk)))
    dets = {"boxes": np.where(real, boxes + rng.normal(0, 1.5, boxes.shape),
                              rand).astype(np.float32),
            "scores": np.sort(rng.uniform(0, 1, (n, k)))[:, ::-1].astype(np.float32),
            "labels": np.where(rng.uniform(size=(n, k)) < 0.8, labels,
                               rng.integers(0, 3, (n, k))).astype(np.int32)}
    if tracking:
        ids = np.pad(batch["ids"][:, :kk], ((0, 0), (0, k - kk)))
        basis = np.random.default_rng(1).normal(size=(64, 8))
        dets["embeddings"] = (basis[ids % 64] + rng.normal(0, 0.1, (n, k, 8))
                              ).astype(np.float32)
        dets["labels"] = np.zeros((n, k), np.int32)
    return dets


def validation_metrics(tracking):
    """The Trainer's validation of `val_batches` with its eval step
    stubbed; in a process group of several, each rank's share. Returns
    (metrics, the number of batches this rank forwarded)."""
    batches = val_batches(tracking)
    dets = {b["image"].tobytes(): stub_detections(b, tracking) for b in batches}
    task = FairMOT(**TRACK) if tracking else CenterNet(**SMALL)
    trainer = Trainer(task, val_loader=batches, max_epochs=1,
                      image_size=(IMG, IMG), device="cpu", optimizer_config=OPT,
                      logger_config={"backends": []}, diagnostics=False,
                      tracker_config=TRACKER if tracking else None)
    forwarded = []

    def eval_step(state, batch):
        forwarded.append(1)
        return {k: torch.from_numpy(v) for k, v in
                dets[batch["image"].numpy().tobytes()].items()}

    trainer.eval_step = eval_step
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the tracker without a model
        metrics = trainer.validate()
    return metrics, len(forwarded)


def scenario_validate(rank, world, tmp):
    return {kind: validation_metrics(kind == "tracking")
            for kind in ("detection", "tracking")}


# ---- the stop agreed across processes --------------------------------------

class Batches:
    """`n` copies of one small detection batch, as a train loader."""
    batch_size = 2

    def __init__(self, n):
        self.n = n
        self.batch = CollateDetection(8)(_items(np.random.default_rng(5), 2))

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter([self.batch] * self.n)


def scenario_stop(rank, world, tmp):
    """Rank 1 alone gets SIGTERM during step 3; the train step only counts."""
    import signal

    trainer = Trainer(CenterNet(**SMALL), train_loader=Batches(25),
                      max_epochs=1, image_size=(IMG, IMG), device="cpu",
                      optimizer_config=OPT, logger_config={"backends": []},
                      diagnostics=False, ckpt_dir=os.path.join(tmp, "ckpt"))

    def step(state, batch):
        state.step += 1
        if rank == 1 and state.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return state, {"total": torch.zeros(())}

    trainer.train_step = step
    state = trainer.fit()
    return {"step": state.step, "stop": trainer._stop_requested,
            "ckpts": sorted(os.listdir(os.path.join(tmp, "ckpt")))}


# ---- the train CLI --------------------------------------------------------

def scenario_cli(rank, world, tmp):
    from centernet_lightning_torch.cli import train as cli_train

    with open(os.path.join(tmp, "cli_args.json")) as f:
        argv = json.load(f)
    rc = cli_train.main(argv)
    return {"rc": rc, "initialized": torch.distributed.is_initialized()}


SCENARIOS = {"steps": scenario_steps, "validate": scenario_validate,
             "stop": scenario_stop, "cli": scenario_cli}


def main():
    name, rank, world, tmp = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4])
    store = torch.distributed.FileStore(os.path.join(tmp, f"{name}.store"),
                                        world)
    torch.distributed.init_process_group("gloo", store=store, rank=rank,
                                         world_size=world)
    try:
        out = SCENARIOS[name](rank, world, tmp)
        torch.save(out, os.path.join(tmp, f"{name}_{rank}.pt"))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
