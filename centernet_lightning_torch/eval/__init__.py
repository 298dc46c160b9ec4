"""Evaluation helpers (port of eval/: the MOT-Challenge results writer)."""
from .utils import write_mot_results

__all__ = ["write_mot_results"]
