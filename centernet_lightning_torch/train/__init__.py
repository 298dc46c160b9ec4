from .config import deep_merge, load_config, normalize_config
from .optim import make_optimizer
from .state import TrainState, make_eval_step, make_train_step
from .trainer import Trainer

__all__ = ["TrainState", "Trainer", "deep_merge", "load_config",
           "make_eval_step", "make_optimizer", "make_train_step",
           "normalize_config"]
