"""trainer.pool_host_ms.train: host ms a train step spends in its replay
pools, the self time of the ``pool`` span, the median over the span
probes. From the program's spans."""

from portbench.spans import read_pool_host_ms as read  # noqa: F401
