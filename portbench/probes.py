"""Counters and spans at the port's layer boundaries, installed by the
benchmark around calls into the program (a traced run only).

  dtw_calls: a count of the calls through the DTW boundary,
             ``CascadeConfig.dtw_fn()`` (``kernels.ops.dtw_band_op`` as
             ``search/cascade.py`` binds it): the engine's rounds and the
             cascade's seeds;
  cascade:   the device time of the engine's calls into ``run_plan``
             (``search/engine.py``).

Spans are CUDA events on the card (no host sync; read once at the end)
and are not taken on the CPU.
"""

from __future__ import annotations

import torch


class Span:
    """Device time of repeated calls: one pair of CUDA events a call."""

    def __init__(self, device: torch.device):
        self.on_card = device.type == "cuda"
        self.events: list[tuple] = []

    def start(self):
        if not self.on_card:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def stop(self, ev) -> None:
        if ev is None:
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.events.append((ev, end))

    def seconds(self) -> float | None:
        """Summed device seconds of the calls (``None`` off the card)."""
        if not self.on_card:
            return None
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events) / 1e3


class Probes:
    """The spans and counters of one traced window."""

    def __init__(self, device: torch.device):
        self.dtw_calls = 0
        self.cascade = Span(device)
        self._undo: list = []

    def install(self) -> None:
        from repro_torch.search import cascade as _cascade
        from repro_torch.search import engine as _engine

        dtw_fn = _cascade.dtw_band_op
        run_plan = _engine.run_plan

        def dtw_probe(*args, **kw):
            self.dtw_calls += 1
            return dtw_fn(*args, **kw)

        def cascade_probe(*args, **kw):
            ev = self.cascade.start()
            out = run_plan(*args, **kw)
            self.cascade.stop(ev)
            return out

        _cascade.dtw_band_op = dtw_probe
        _engine.run_plan = cascade_probe
        self._undo = [(_cascade, "dtw_band_op", dtw_fn),
                      (_engine, "run_plan", run_plan)]

    def remove(self) -> None:
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        self._undo = []
