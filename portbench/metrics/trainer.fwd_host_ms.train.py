"""trainer.fwd_host_ms.train: host ms a train step spends in its forwards,
the self time of the program's ``g_forward`` and ``d_forward`` spans, the
median over the span probes (each step from an idle device). From the
program's spans."""

from portbench.spans import read_fwd_host_ms as read  # noqa: F401
