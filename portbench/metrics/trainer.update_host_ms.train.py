"""trainer.update_host_ms.train: host ms a train step spends in its two
updates (Adam and the LambdaLR), the self time of the ``g_update`` and
``d_update`` spans, the median over the span probes. From the program's
spans."""

from portbench.spans import read_update_host_ms as read  # noqa: F401
