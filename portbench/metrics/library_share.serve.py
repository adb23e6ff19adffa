"""library_share.serve: the share of the traced stretch's device time spent
in operations that are not the port's own kernels (cuDNN convolutions,
Adam, elementwise, copies), in %. From the device trace."""

from portbench.readings import library_share as read  # noqa: F401
