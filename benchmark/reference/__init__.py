"""Plain float32 PyTorch references of the benchmark's configurations.

Nothing here imports the program under test: the models, the decode, the
loss and the optimizer are written from the published recipes."""
