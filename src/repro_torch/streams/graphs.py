"""A fleet bucket's whole tick loop as one CUDA graph.

A bucket run (:func:`repro_torch.streams.simulator._run_bucket`) is a host
loop that issues ~130 small device operations a tick under
``torch.func.vmap`` and never reads a device value back; on a card the
host's ~25 µs an operation, not the device, paces it. :class:`BucketGraphs`
captures the run once per *signature* (stream, static arguments, and every
input's shape and dtype) as one ``torch.cuda.CUDAGraph`` and replays it for
every later bucket with that signature::

    graphs = BucketGraphs()
    outs = graphs.run(pack, n_apps, "appaware", n_ticks, dt, upd_every,
                      solver="waterfill", enforce=enf, t_event=50.0)

The captured body is :func:`_run_bucket` itself, so the eager loop and the
graph share every line of tick logic and run the same kernels in the same
order on the same float32 data: a replay's outputs are the eager run's, bit
for bit. A replay copies the bucket's inputs into the entry's static
tensors, replays, and returns clones of the graph's outputs, all on the
current stream, so a caller may keep several results of one signature in
flight on one stream. Each stream has entries of its own: two streams never
share static buffers.

The first bucket run on a card runs eager (cuBLAS handles and workspaces,
kernel loading, the waterfill library's build: nothing a capture may do)
and its signature is captured after it. A capture runs on a side stream of
the card with a private memory pool, in ``thread_local`` mode (the
campaign's copy worker keeps copying meanwhile). A capture that raises
leaves its signature to the eager loop from then on (``fallbacks``).

On the CPU every call is the eager loop. Spans (:mod:`repro_torch.tracing`):
``capture`` and ``replay`` around the two; the tick loop's own spans are
kept out of the recording while it is captured, since they would time the
capture, not the run.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tracing
from repro_torch.streams.simulator import _run_bucket


def _shape(t) -> "tuple | None":
    return None if t is None else (tuple(t.shape), t.dtype)


def signature(pack: "dict[str, torch.Tensor]", x_fixed, enforce, stream,
              n_apps: int, policy: str, n_ticks: int, dt: float,
              upd_every: int, alpha: float, n_groups: int, qcap: float,
              solver: str, with_metrics: bool, t_event: float) -> tuple:
    """What a bucket run's graph depends on: the device and ``stream`` it
    runs on, the static arguments, whether ``x_fixed`` and ``enforce`` are
    given (and their shapes), and every pack field's shape and dtype."""
    return ((pack["R"].device, stream), policy, n_apps, n_ticks, dt,
            upd_every, alpha, n_groups, qcap, solver, with_metrics, t_event,
            _shape(x_fixed), _shape(enforce),
            tuple((k, *_shape(v)) for k, v in sorted(pack.items())))


@dataclasses.dataclass
class _Entry:
    """One captured signature: its static inputs, the graph, the graph's
    outputs, and the waterfill launches recorded in it."""
    pack: "dict[str, torch.Tensor]"
    x_fixed: "torch.Tensor | None"
    enforce: "torch.Tensor | None"
    graph: "torch.cuda.CUDAGraph"
    outs: tuple
    n_launches: int


class BucketGraphs:
    """The graphs of one :class:`~repro_torch.streams.fleet.FleetRunner`,
    by :func:`signature`, and counts of what :meth:`run` did: ``captures``,
    ``replays`` and ``fallbacks`` (captures that raised)."""

    def __init__(self):
        self._entries: dict[tuple, _Entry | None] = {}
        self._warm: set[torch.device] = set()
        self._side: dict[torch.device, torch.cuda.Stream] = {}
        self.captures = self.replays = self.fallbacks = 0

    def clear(self) -> None:
        """Drop every graph, once the cards have finished their replays
        (a graph's pool is reused as soon as it is dropped)."""
        for dev in {k[0][0] for k in self._entries}:
            if dev.type != "cuda":
                continue
            try:
                torch.cuda.synchronize(dev)
            except RuntimeError:  # a failed card: nothing runs on it
                pass
        self._entries.clear()

    def run(self, pack, n_apps, policy, n_ticks, dt, upd_every, x_fixed=None,
            alpha=0.5, n_groups=8, qcap=8.0, solver="sort", enforce=None,
            with_metrics=True, t_event=0.0):
        """:func:`_run_bucket`'s outputs for these arguments (its whole
        run; ``stepwise`` stays eager), from a graph where the pack is on a
        card."""
        args = (n_apps, policy, n_ticks, dt, upd_every)
        kw = dict(alpha=alpha, n_groups=n_groups, qcap=qcap, solver=solver,
                  with_metrics=with_metrics, t_event=t_event)
        dev = pack["R"].device
        if dev.type != "cuda":
            return _run_bucket(pack, *args, x_fixed=x_fixed, enforce=enforce,
                               **kw)
        stream = torch.cuda.current_stream(dev)
        key = signature(pack, x_fixed, enforce, stream.cuda_stream, *args,
                        **kw)
        eager = None
        if dev not in self._warm:
            eager = _run_bucket(pack, *args, x_fixed=x_fixed,
                                enforce=enforce, **kw)
            self._warm.add(dev)
        if key not in self._entries:
            self._entries[key] = self._capture(dev, pack, x_fixed, enforce,
                                               args, kw)
        entry = self._entries[key]
        if eager is not None:
            return eager
        if entry is None:
            return _run_bucket(pack, *args, x_fixed=x_fixed, enforce=enforce,
                               **kw)
        return self._replay(entry, dev, stream, pack, x_fixed, enforce)

    def _capture(self, dev, pack, x_fixed, enforce, args, kw):
        from repro_torch.kernels.waterfill import ops

        def like(t):
            return None if t is None else torch.empty_like(t)

        with tracing.span("capture", rows=pack["R"].shape[0]):
            static = {k: torch.empty_like(v) for k, v in pack.items()}
            xf, enf = like(x_fixed), like(enforce)
            side = self._side.get(dev)
            if side is None:
                side = self._side[dev] = torch.cuda.Stream(dev)
            graph = torch.cuda.CUDAGraph()
            before = ops.CAPTURED
            try:
                with tracing.recording(), torch.cuda.stream(side):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        outs = _run_bucket(static, *args, x_fixed=xf,
                                           enforce=enf, **kw)
                    except BaseException:
                        try:
                            graph.capture_end()
                        except RuntimeError:  # the capture was invalidated
                            pass
                        raise
                    graph.capture_end()
            except Exception:  # noqa: BLE001 — this signature runs eager
                self.fallbacks += 1
                return None
            self.captures += 1
            return _Entry(static, xf, enf, graph, outs,
                          ops.CAPTURED - before)

    def _replay(self, entry: _Entry, dev, stream, pack, x_fixed, enforce):
        from repro_torch.kernels.waterfill import ops

        with tracing.span("replay", rows=pack["R"].shape[0]):
            for k, t in entry.pack.items():
                t.copy_(pack[k])
            for t, src in ((entry.x_fixed, x_fixed),
                           (entry.enforce, enforce)):
                if t is not None:
                    t.copy_(src)
            entry.graph.replay()
            ops.count_launches(entry.n_launches, dev.index, stream.cuda_stream)
            self.replays += 1
            return tuple(t.clone() for t in entry.outs)
