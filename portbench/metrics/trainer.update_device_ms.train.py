"""trainer.update_device_ms.train: device ms a train step of the operations
launched inside the ``g_update`` and ``d_update`` spans (Adam and the
LambdaLR), over the traced stretch. From the device trace, each operation
given to the span that held the start of the call that launched it."""

from portbench.spans import read_update_device_ms as read  # noqa: F401
