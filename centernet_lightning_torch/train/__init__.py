from .config import deep_merge, load_config, normalize_config

__all__ = ["deep_merge", "load_config", "normalize_config"]
