"""The comparison that decides `correct`, on the CPU at a small size: a
sound run passes, and the run comes out not correct with the timed path
broken underneath (each fault a cell can have) or with the lower-precision
control in the program's place. The harness's look for a card is skipped:
the cells run on the CPU, where the port runs its kernels' plain twins."""
import pytest
import torch

import control
from cnbench import judge, manifest
from cnbench.kinds import train as train_kind
from cnbench.runner import run

SERVE = "csp53-serve-b64"
TRAIN = ("r18dcn-train-b128", "csp53-train-b32")


def verdict(cell):
    result, checks = run(cell, manifest.manifest())
    return result["correct"], {k: c["value"] for k, c in checks.items()}


def test_sound_serving_run_is_correct(tiny_cell):
    ok, numbers = verdict(tiny_cell(SERVE, dtype="float32"))
    assert ok, numbers


def _shifted(monkeypatch):
    from centernet_lightning_torch.ops import decode as decode_ops

    monkeypatch.setattr(decode_ops, "assemble_detections", decode_ops.assemble_detections)
    control.shifted_pixels()


@pytest.mark.parametrize("hook", [control.half_answers, control.altered_answers,
                                  control.no_peak_test, _shifted],
                         ids=["half_of_the_batch", "answer_altered", "no_peak_test",
                              "pixels_shifted"])
def test_serving_fault_is_not_correct(tiny_cell, monkeypatch, hook):
    # one batch, whose maps at this size give the decode faults pixels to
    # pick off the peaks
    cell = tiny_cell(SERVE, dtype="float32", distinct_batches=1)
    if hook is _shifted:
        hook(monkeypatch)
    else:
        cell.predictor_hook = hook
    ok, numbers = verdict(cell)
    assert not ok, numbers


def test_serving_int8_control_is_not_correct(tiny_cell):
    cell = tiny_cell(SERVE)
    cell.predictor_hook = control.int8
    ok, numbers = verdict(cell)
    assert not ok, numbers


@pytest.mark.parametrize("workload", TRAIN)
def test_sound_training_run_is_correct(tiny_cell, workload):
    ok, numbers = verdict(tiny_cell(workload, dtype="float32"))
    assert ok, numbers


def _unchanged_steps(monkeypatch):
    """Each step computes its losses and leaves the state as it was."""
    import centernet_lightning_torch.train as train_pkg

    make = train_pkg.make_train_step

    def make_unchanged(task, **kw):
        step = make(task, **kw)

        def unchanged(state, batch):
            saved = {k: v.clone() for k, v in state.model.state_dict().items()}
            slots = {k: dict(v) for k, v in state.tx.slots.items()}
            count = state.tx.count
            state, losses = step(state, batch)
            state.model.load_state_dict(saved)
            state.tx.slots, state.tx.count = slots, count
            return state, losses
        return unchanged
    monkeypatch.setattr(train_pkg, "make_train_step", make_unchanged)


def _half_steps(monkeypatch):
    import centernet_lightning_torch.train as train_pkg

    monkeypatch.setattr(train_pkg, "make_train_step", train_pkg.make_train_step)
    control.half_batch_steps()


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged_steps, _half_steps],
                         ids=["state_unchanged", "half_of_the_batch"])
def test_training_fault_is_not_correct(tiny_cell, monkeypatch, workload, fault):
    fault(monkeypatch)
    ok, numbers = verdict(tiny_cell(workload, dtype="float32"))
    assert not ok, numbers


@pytest.mark.parametrize("workload", TRAIN)
def test_training_int8_control_is_not_correct(tiny_cell, workload):
    cell = tiny_cell(workload)
    spec, params, images, boxes = train_kind.inputs(cell)
    ref = train_kind.reference_readings(cell, spec, params, images, boxes)
    low = train_kind.reference_readings(cell, spec, params, images, boxes, lowp="int8")
    ok, checks = judge.verdict(judge.training_gaps(low, ref), cell.limits)
    assert not ok, checks
