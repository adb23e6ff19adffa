"""unet.up_device_ms.train: device ms a train step of the operations launched
inside the U-Net levels' ``unet.up`` spans
(``models/generators.py::UnetLevel``): the ReLU, the 4x4 stride-2 transposed
convolution, its instance norm and dropout of every level. Over the traced
stretch, each operation given to the span that held the start of the call that
launched it; the backward, launched under ``g_backward``, is not counted. From
the device trace and the program's spans; None where no ``unet.up`` span ran
or no device work lay inside one."""

from portbench.spans import _stretch, _under, device_ns, roots

SPAN = "unet.up"


def _device_ms(spans, calls):
    steps = len(roots(spans, "train_step"))
    if not steps or not any(s.name == SPAN for s in spans):
        return None
    ns = _under(spans, device_ns(spans, calls), {SPAN})
    return ns / steps * 1e-6 if ns else None


def read(obs):
    return _stretch(_device_ms, obs)
