"""serve_host_ms: the median host ms to make and enqueue one served batch
(the predictor's call on a host batch, returning before the device is
done), each call made on an idle device (host clock, a few calls before the
traced stretch)."""

from portbench.readings import host_ms as read  # noqa: F401
