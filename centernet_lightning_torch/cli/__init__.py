"""Command-line entry points (ports of the root train.py and of
tools/{pack_dataset,validate,detect,track}.py), each run as
`python -m centernet_lightning_torch.cli.<name> --help`. They run on the
card (`--device cuda`, the default) unless `--device cpu` is passed."""

__all__ = ["refuse_quantize"]


def refuse_quantize(n: int) -> None:
    """`--quantize N` with N > 0 asks for int8 serving, which the port does
    not have yet: exit non-zero before anything is served."""
    if n > 0:
        raise SystemExit("--quantize: int8 serving is not ported yet "
                         "(ROADMAP Queue 1 item 6); nothing was served")
