"""Process-pool feed: one feed per worker process behind the Feed protocol;
own copy of ``runtime/vector_feed.py``.

:class:`VectorFeedPool` starts one worker per feed factory, each owning a
live feed (synthetic, floorplan or recorded), and exposes

  - batched ``reset()`` / ``step(actions)`` that dispatch to every worker
    first and then collect, so N feeds render in parallel on host cores
    while the card runs the previous step;
  - per-index :class:`FeedProxy` objects satisfying the Feed protocol
    (with the oracle RPCs ``cand_dist_to_goal`` / ``get_cand_real_pos`` /
    ``get_observation``), so ``EpisodeRunner.run`` / ``evaluate`` /
    ``VLNTrainer`` drive pooled feeds unchanged.

Workers are forkserver-started by default: a child ``fork()``ed after CUDA
is initialised has no usable CUDA context, and one forked from a process
with threads can deadlock.  Factories must therefore be picklable
(module-level functions, classes, or ``functools.partial`` over them, not
lambdas), and the feeds send numpy arrays only, never a tensor.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Any, Callable, List, Sequence, Tuple

from dynam3d_torch.runtime.feed import Observation

_CLOSE = "__close__"
_RESOLVE = "__resolve__"


def _worker(factory: Callable, conn) -> None:
    feed = factory()
    try:
        while True:
            msg = conn.recv()
            if msg[0] == _CLOSE:
                conn.close()
                return
            name, args, kwargs = msg
            try:
                if name == _RESOLVE:
                    # attribute probe: data attributes come back by value,
                    # methods as a marker (the proxy then RPCs the call)
                    attr = getattr(feed, args[0])
                    result = ("method", None) if callable(attr) else ("value", attr)
                else:
                    result = getattr(feed, name)(*args, **kwargs)
                conn.send((True, result))
            except Exception as e:  # surface worker errors to the caller
                conn.send((False, f"{type(e).__name__}: {e}"))
    except (EOFError, KeyboardInterrupt):
        return


class FeedProxy:
    """Feed-protocol view of one pooled worker (synchronous RPC).

    Attribute access probes the worker: data attributes of the live feed
    (``goal``, ``gt_locations``, ``instruction``) come back by value, so
    ``getattr(feed, "goal", None)``-style consumers see real data rather
    than a truthy bound-RPC function; methods come back as RPC callables.
    """

    def __init__(self, pool: "VectorFeedPool", idx: int):
        self._pool = pool
        self._idx = idx
        self._methods: set = set()  # probe cache: names known to be methods

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._methods:
            try:
                kind, value = self._pool._rpc(self._idx, _RESOLVE, (name,))
            except RuntimeError as e:
                if "AttributeError" in str(e):
                    raise AttributeError(name) from None
                raise
            if kind == "value":
                return value  # data attributes re-fetch every access
            self._methods.add(name)

        def call(*args, **kwargs):
            return self._pool._rpc(self._idx, name, args, kwargs)

        return call


class VectorFeedPool:
    """N feeds in N forked workers with dispatch/collect batching."""

    def __init__(self, factories: Sequence[Callable], start_method: str = "forkserver"):
        ctx = mp.get_context(start_method)
        self._conns = []
        self._procs = []
        for factory in factories:
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker, args=(factory, child), daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self.feeds: List[FeedProxy] = [
            FeedProxy(self, i) for i in range(len(factories))
        ]

    def __len__(self) -> int:
        return len(self._conns)

    # --- low-level async RPC ------------------------------------------------
    def _send(self, idx: int, name: str, args=(), kwargs=None) -> None:
        self._conns[idx].send((name, args, kwargs or {}))

    def _recv(self, idx: int):
        ok, result = self._conns[idx].recv()
        if not ok:
            raise RuntimeError(f"feed worker {idx}: {result}")
        return result

    def _rpc(self, idx: int, name: str, args=(), kwargs=None):
        self._send(idx, name, args, kwargs)
        return self._recv(idx)

    def call(self, name: str, per_feed_args: Sequence[Tuple]) -> List[Any]:
        """Dispatch ``name(*args)`` to every worker, then collect in order.

        Every dispatched response is ALWAYS read, even when an earlier
        worker failed — leaving a computed response unread in a pipe would
        silently desync every later RPC on that index by one message.  The
        first failure is raised after the drain.
        """
        for i, args in enumerate(per_feed_args):
            self._send(i, name, tuple(args))
        results, first_err = [], None
        for i in range(len(self)):
            try:
                results.append(self._recv(i))
            except (RuntimeError, EOFError, OSError) as e:
                # a dead worker (EOFError) must not abort the drain: the
                # other pipes still hold computed responses
                results.append(None)
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err if isinstance(first_err, RuntimeError) else (
                RuntimeError(f"feed worker died: {first_err!r}")
            )
        return results

    # --- batched Feed surface ----------------------------------------------
    def reset(self) -> List[Observation]:
        return self.call("reset", [()] * len(self))

    def step(self, actions: Sequence) -> List[Tuple[Observation, bool, dict]]:
        return self.call("step", [(a,) for a in actions])

    def close(self) -> None:
        for c in self._conns:
            try:
                c.send((_CLOSE,))
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=5)
        for c in self._conns:
            c.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
