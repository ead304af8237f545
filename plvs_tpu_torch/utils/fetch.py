"""Device-to-host fetches for the deferred runtime.

Counterpart of the JAX package's ``jax.device_get`` on a helper thread
(``plvs_tpu/slam/tracking.py`` resolve double buffer,
``plvs_tpu/slam/system.py`` ``_submit_backend_fetch``) and of its inline
``_LazyFuture`` / ``_SyncFetch`` (``plvs_tpu/slam/local_mapping.py``).

A fetch takes a tree of outputs (tensors in nested tuples, lists and dicts;
other leaves pass through) and returns a future of the same tree with numpy
arrays. :class:`SyncFetch` reads at ``result()`` on the calling thread.
:class:`HelperFetch` splits the read: the launching thread queues one
``non_blocking`` copy per CUDA tensor into pinned host memory and records an
event right behind them; the helper thread only waits on that event. A plain
``.cpu()`` on the helper thread would wait for everything queued on the
stream, frames launched after the group included. CPU tensors are copied at
submit time, so a fetch is a snapshot on every device. Only the waits run
off the launching thread.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def to_host(tree):
    """Every tensor of ``tree`` -> numpy, read now (one device-to-host copy
    each)."""
    return _map(lambda x: x.detach().cpu().numpy()
                if isinstance(x, torch.Tensor) else x, tree)


def _queue_copy(x):
    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach()
    if x.device.type != "cuda":
        return x.clone()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return host


def queue_host_copy(tree):
    """Launching-thread half of a fetch: (host tree, event or None). The
    host tree holds pinned buffers that the queued copies fill; the event,
    recorded on the current stream behind the copies, fires when they
    landed (None when no tensor lies on a CUDA device)."""
    on_cuda = []
    _map(lambda x: on_cuda.append(x) if isinstance(x, torch.Tensor)
         and x.device.type == "cuda" else None, tree)
    host = _map(_queue_copy, tree)
    event = None
    if on_cuda:
        event = torch.cuda.Event()
        event.record()
    return host, event


def wait_host_copy(host, event):
    """Helper-thread half: wait for the copies, then numpy views."""
    if event is not None:
        event.synchronize()
    return to_host(host)


class LazyFuture:
    """Future-compatible wrapper that fetches on ``result()`` (the inline
    path: the read is charged where the result is asked for)."""

    def __init__(self, outs):
        self._outs = outs

    def result(self):
        return to_host(self._outs)

    def done(self):
        return True


class SyncFetch:
    """submit-compatible inline fetcher: ``fetch(outs) -> LazyFuture``."""

    def __call__(self, outs):
        return LazyFuture(outs)


class HelperFetch:
    """submit-compatible fetcher whose waits run on ``workers`` helper
    threads (each enters ``device`` first); ``fetch(outs)`` returns a
    ``concurrent.futures.Future`` of the host tree."""

    def __init__(self, device: torch.device, workers: int = 1,
                 name: str = "plvs-fetch"):
        self.device = torch.device(device)
        init = None
        if self.device.type == "cuda":
            index = (self.device.index if self.device.index is not None
                     else torch.cuda.current_device())

            def init():
                torch.cuda.set_device(index)
        self.pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix=name,
                                       initializer=init)

    def __call__(self, outs):
        host, event = queue_host_copy(outs)
        return self.pool.submit(wait_host_copy, host, event)

    def shutdown(self):
        self.pool.shutdown(wait=True)

