from .inference import InferenceDataset

__all__ = ["InferenceDataset"]
