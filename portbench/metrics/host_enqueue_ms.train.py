"""host_enqueue_ms.train: the median host ms until a ``train_step`` call
returns, each call made on an idle device with no synchronize inside (host
clock, a few calls before the traced stretch)."""

from portbench.readings import host_ms as read  # noqa: F401
