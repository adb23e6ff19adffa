"""kernels.conv_roofline.train: the roofline share of the port's convolution
kernels, in %: the least time of the convolutions that the stretch's units
need of them (portbench/work/calls.py: forward, input and weight
gradients, nothing recomputed or split), over the device time of every
kernel their C entries launch. None where none of them ran."""

from portbench.readings import conv_roofline as read  # noqa: F401
