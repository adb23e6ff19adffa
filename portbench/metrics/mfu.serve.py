"""mfu.serve: the model FLOPs of the units completed in the traced stretch
(portbench/work/model.py, nothing recomputed counted) over the stretch's
seconds at the H100's published bf16 peak of 989 TFLOP/s, in %."""

from portbench.readings import mfu as read  # noqa: F401
