"""trainer.launches.train: the CUDA runtime calls that enqueue device work
(kernel and graph launches, async copies and fills) that start inside a
``train_step`` span, a step of the traced stretch. From the device trace's
runtime calls."""

from portbench.spans import read_launches as read  # noqa: F401
