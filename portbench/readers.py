"""What the per-layer metric readers (``metrics/<metric>.py``) share. Each
takes a ``trace.Reading`` and returns a number, or None where the trace has
nothing for it to read (no device activity, or no kernel of its layer)."""
from __future__ import annotations

from . import counts
from .peaks import H100_SXM, least_seconds


def _on_device(reading) -> bool:
    return reading.busy_s > 0


def layer_ms(reading, layer: str):
    """Device ms of a layer's kernels a unit (micro-step or request)."""
    s = reading.layer_s.get(layer, 0.0)
    return 1e3 * s / reading.units if s > 0 and reading.units else None


def _spans(reading) -> tuple:
    """(seconds inside the traced units, device-busy seconds inside them)."""
    spans = reading.unit_spans
    return sum(e - s for s, e, _ in spans), sum(busy for _, _, busy in spans)


def idle_share(reading, training: bool):
    """Share with no device activity, in %: of the traced window in
    training (blocks queued back to back); of the requests' own spans in
    serving, so that the loop's time between requests does not count."""
    if not _on_device(reading):
        return None
    if training:
        return 100.0 * (1.0 - reading.busy_s / reading.window_s)
    spent, busy = _spans(reading)
    return 100.0 * (1.0 - busy / spent)


def mfu(reading, training: bool):
    """The model's operations (the valid work of each traced unit,
    ``counts.model_forward_flops``; three times it a training micro-step)
    over the time they took times the float32 peak, in %: the traced
    window in training, the sum of the requests' spans (send to answer on
    the host) in serving."""
    if not _on_device(reading):
        return None
    fam, cfg = reading.extra["family"], reading.extra["config"]
    total = sum(fam.forward_flops(cfg, c) for c in reading.counts)
    if training:
        total = counts.train_flops(total)
    seconds = reading.window_s if training else _spans(reading)[0]
    return 100.0 * total / (seconds * H100_SXM["f32_flops"])


def pair_roofline(reading, backward: bool):
    """Least time of the traced units' pair-kernel launches over their
    device time, in %: K10b's (pair_bwd) or K10f's (pair_fwd)."""
    layer = "pair_bwd" if backward else "pair_fwd"
    spent = reading.layer_s.get(layer, 0.0)
    if spent <= 0:
        return None
    fam, cfg, mix = reading.extra["family"], reading.extra["config"], reading.extra["mix"]
    count = counts.pair_backward if backward else counts.pair_forward
    least = sum(least_seconds(*count(**launch))
                for c in reading.counts for launch in fam.pair_launches(cfg, mix, c))
    return 100.0 * least / spent


def host_gap_ms(reading):
    """The mean, over the traced units, of a unit's length less the device's
    busy time inside it, in ms."""
    if not _on_device(reading):
        return None
    spans = reading.unit_spans
    return 1e3 * sum(e - s - busy for s, e, busy in spans) / len(spans)
