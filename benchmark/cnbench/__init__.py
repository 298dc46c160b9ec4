"""The benchmark harness of centernet_lightning_torch."""
