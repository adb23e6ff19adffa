"""device_idle_share.serve: the share of the traced stretch in which no
operation ran on the device (1 minus the union of device events over the
stretch), in %. From the device trace."""

from portbench.readings import idle_share as read  # noqa: F401
