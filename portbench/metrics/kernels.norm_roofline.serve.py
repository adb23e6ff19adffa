"""kernels.norm_roofline.serve: the roofline share of the port's instance
norm kernels (forward and VJP), in %: the least time of the norm passes
that the stretch's units need (portbench/work/calls.py, nothing
recomputed), over the device time of those kernels. None where none of
them ran."""

from portbench.readings import norm_roofline as read  # noqa: F401
