"""One module a kind of traffic: `run(cell) -> result` builds the
program from the cell's configuration, warms it, drives the window,
checks what it produced against the reference and returns the numbers."""
