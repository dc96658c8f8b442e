"""repro_torch.serve — the serving subsystem, as far as this slice goes.

Only the request unit and its queue (``queue.py``, the JAX package's own
pure-Python module, copied) are here so far. The router, the batcher, the
metrics and the fault-recovering ``ServeEngine`` come with the control
plane in the next slice.
"""
from repro_torch.serve.queue import LegionQueue, Request

__all__ = ["LegionQueue", "Request"]
