"""Model FLOPs the timed part's recordings need (the real windows' valid
frames; no padding rows or bucket windows), over its time and the
configuration dtype's peak, in %."""

from yardstick.peaks import PEAK_FLOPS


def read(run):
    flops = run.tally.get("flops")
    if not run.part_s or not flops:
        return None
    return 100.0 * flops / run.part_s / PEAK_FLOPS[run.dtype]
