"""trainer.host_syncs.train: the CUDA runtime calls that block the host on
the device (synchronizes, ``cudaMemcpy``, async copies to the host) that
start inside a ``train_step`` span, a step of the traced stretch. From the
device trace's runtime calls; 0 where the step never waits."""

from portbench.spans import read_host_syncs as read  # noqa: F401
