"""trainer.bwd_host_ms.train: host ms a train step spends in its backwards,
the self time of the ``g_backward`` and ``d_backward`` spans (the caller
waiting in ``torch.autograd.grad`` while the engine's thread launches), the
median over the span probes. From the program's spans."""

from portbench.spans import read_bwd_host_ms as read  # noqa: F401
