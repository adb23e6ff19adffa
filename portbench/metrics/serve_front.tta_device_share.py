"""serve_front.tta_device_share: of the device time launched inside the
predictor's ``serve.predict`` spans in the traced stretch, the share
launched outside every ``serve.forward`` (the generator): the TTA's
resizes, flips, tile gathers and stitches, and the argmax, in %. From the
device trace and the program's spans; None where nothing ran inside
``serve.predict``."""

from portbench.spans import read_tta_device_share as read  # noqa: F401
