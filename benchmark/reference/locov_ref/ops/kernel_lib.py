"""No kernels: the reference runs the plain versions on every device.
The names the plain modules import are kept so that they load; a call
that would launch a kernel raises."""
import collections

LAUNCHES = collections.Counter()


def load(name):
    raise RuntimeError(f"the reference has no kernels ({name})")


def check_cuda_tensor(*args, **kwargs):
    raise RuntimeError("the reference has no kernels")


def check_launch(*args, **kwargs):
    raise RuntimeError("the reference has no kernels")


def stream_ptr(*args, **kwargs):
    raise RuntimeError("the reference has no kernels")
