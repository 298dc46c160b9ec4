"""Command-line entry points (ports of the root train.py and of
tools/{pack_dataset,validate,detect,track,serve,export,convert_checkpoint}.py),
each run as `python -m centernet_lightning_torch.cli.<name> --help`. They
run on the card (`--device cuda`, the default) unless `--device cpu` is
passed."""

__all__ = ["read_class_names"]


def read_class_names(path):
    """Class names from a json list or a text file of one name a line
    (`--class-names` of detect and serve); None without a path."""
    if not path:
        return None
    import json

    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return [line.strip() for line in text.splitlines() if line.strip()]
